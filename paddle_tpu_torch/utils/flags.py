"""Environment knobs: the port's own copy of the host-only readers of
``paddle_tpu/utils/flags.py`` (``env_bool``/``env_flag``, ``env_int``),
so that ``PT_*`` variables mean the same in both packages."""
from __future__ import annotations

import os

__all__ = ["env_bool", "env_flag", "env_int"]


def env_bool(name: str, default: bool = False) -> bool:
    """A boolean env toggle with uniform falsy spellings ('', '0',
    'false', 'off', 'no' — case/whitespace-insensitive)."""
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("", "0", "false", "off", "no")


# historical name — env_bool is the canonical spelling
env_flag = env_bool


def env_int(name: str, default: int) -> int:
    """A ``PT_*`` integer env knob. Empty/whitespace values fall back to
    the default; a malformed non-empty value raises."""
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    return int(v.strip())
