"""Ini configuration with %{var} substitution.

Port of pegasus_tpu/runtime/config.py's Config: the ini reader of the
server entry point (server/__main__.py) and its apps. The typed flag
registry is not ported (nothing in the port defines a flag).
"""

import configparser
import re

_VAR_RE = re.compile(r"%\{([^}]+)\}")


class Config:
    """An ini config with %{var} substitution.

    Variables resolve against a substitution dict passed at load (the
    reference substitutes launch-time variables like %{cluster.name}).
    """

    def __init__(self, path: str = None, text: str = None, variables: dict = None):
        self._parser = configparser.ConfigParser(
            interpolation=None, strict=False, delimiters=("=",),
            # rDSN-style inis comment inline ("key = value  # why"); without
            # this the comment travels INTO the value and e.g.
            # compaction_backend = "tpu   # ..." KeyErrors at first merge
            inline_comment_prefixes=("#", ";"),
        )
        self._parser.optionxform = str  # case-sensitive keys like rDSN
        self._variables = dict(variables or {})
        if path is not None:
            with open(path) as f:
                text = f.read()
        if text is not None:
            self._parser.read_string(self._substitute(text))

    def _substitute(self, text: str) -> str:
        return _VAR_RE.sub(lambda m: str(self._variables.get(m.group(1), m.group(0))), text)

    def sections(self):
        return self._parser.sections()

    def has_section(self, section: str) -> bool:
        return self._parser.has_section(section)

    def keys(self, section: str):
        return list(self._parser[section]) if self.has_section(section) else []

    def get_string(self, section: str, key: str, default: str = "") -> str:
        try:
            return self._parser.get(section, key)
        except (configparser.NoSectionError, configparser.NoOptionError):
            return default

    def get_int(self, section: str, key: str, default: int = 0) -> int:
        v = self.get_string(section, key, None)
        return default if v is None or not v.strip() else int(v)

    def get_float(self, section: str, key: str, default: float = 0.0) -> float:
        v = self.get_string(section, key, None)
        return default if v is None or not v.strip() else float(v)

    def get_bool(self, section: str, key: str, default: bool = False) -> bool:
        v = self.get_string(section, key, None)
        if v is None:
            return default
        return v.strip().lower() in ("true", "1", "yes", "on")

    def get_list(self, section: str, key: str, default=()):
        v = self.get_string(section, key, None)
        if v is None:
            return list(default)
        return [s.strip() for s in v.split(",") if s.strip()]

    def set(self, section: str, key: str, value) -> None:
        if not self._parser.has_section(section):
            self._parser.add_section(section)
        self._parser.set(section, key, str(value))
