"""Flag parsing with the semantics of Flink's ``ParameterTool.fromArgs``.

Every entry point in the reference parses flags via
``ParameterTool.fromArgs(args)`` (e.g. ``ALSImpl.scala:18``, ``SGD.java:40``,
``MSE.java:36``).  This module reproduces those semantics so the new
framework's CLIs accept the exact flag inventory in SURVEY.md Appendix A:

- flags are ``--key value`` or ``-key value``
- a flag followed by another flag (or end of argv) is a valueless boolean flag
- ``get*`` accessors with defaults, ``getRequired`` raising on absence
- unknown flags are carried, not rejected (Flink passes them through to e.g.
  Kafka properties — ``ALSKafkaConsumer.java:70``)

Own copy of ``flink_ms_tpu/core/params.py``: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

_NO_VALUE = "__NO_VALUE_KEY"


class Params:
    """Immutable-ish key/value flag map (ParameterTool parity)."""

    def __init__(self, data: Dict[str, str]):
        self._data = dict(data)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_args(cls, args: Iterable[str]) -> "Params":
        data: Dict[str, str] = {}
        toks: List[str] = list(args)
        i = 0
        while i < len(toks):
            tok = toks[i]
            if tok.startswith("--"):
                key = tok[2:]
            elif tok.startswith("-") and not _is_number(tok):
                key = tok[1:]
            else:
                raise ValueError(
                    f"Error parsing arguments '{toks}' on '{tok}'. "
                    "Please prefix keys with -- or -."
                )
            if not key:
                raise ValueError("The input " + str(toks) + " contains an empty argument")
            i += 1
            if i >= len(toks):
                data[key] = _NO_VALUE
            else:
                nxt = toks[i]
                if nxt.startswith("-") and not _is_number(nxt):
                    data[key] = _NO_VALUE
                else:
                    data[key] = nxt
                    i += 1
        return cls(data)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "Params":
        return cls({k: str(v) for k, v in d.items()})

    # -- accessors ---------------------------------------------------------

    def has(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        v = self._data.get(key)
        if v is None or v == _NO_VALUE:
            return default
        return v

    def get_required(self, key: str) -> str:
        if key not in self._data:
            raise KeyError(f"No data for required key '{key}'")
        v = self._data[key]
        if v == _NO_VALUE:
            raise ValueError(f"The argument for required key '{key}' is missing")
        return v

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self.get(key)
        return int(v) if v is not None else default

    def get_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        v = self.get(key)
        return float(v) if v is not None else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._data.get(key)
        if v is None:
            return default
        if v == _NO_VALUE:
            # bare `--partition` style flag counts as true (ParameterTool
            # returns the default there; the reference always passes a value,
            # so treating bare presence as true is a strict superset)
            return True
        return v.strip().lower() in ("true", "1", "yes")

    def to_dict(self) -> Dict[str, str]:
        return dict(self._data)

    def properties(self, prefix: str = "") -> Dict[str, str]:
        """All flags (optionally filtered by prefix) as a properties dict —
        the analog of ``parameterTool.getProperties()`` passed to Kafka at
        ``ALSKafkaConsumer.java:70``."""
        out = {}
        for k, v in self._data.items():
            if k.startswith(prefix) and v != _NO_VALUE:
                out[k] = v
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"Params({self._data!r})"


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def field_delimiter_from(params: Params, default: str = "comma") -> str:
    """Map the reference's ``--fieldDelimiter comma|tab`` convention
    (``ALSImpl.scala:22-26``) to the actual character.  Raw one-char
    delimiters are also accepted."""
    v = params.get("fieldDelimiter", default)
    if v == "comma":
        return ","
    if v == "tab":
        return "\t"
    if len(v) == 1:
        return v
    raise ValueError(f"unsupported fieldDelimiter: {v!r} (use comma|tab)")
