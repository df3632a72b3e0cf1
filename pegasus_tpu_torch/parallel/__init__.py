"""Merges across what a host owns (one card today)."""
