"""The RPC layer: codec, the offload plane's messages, TCP transport."""
