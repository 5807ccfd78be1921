"""Environment knobs and the FLAGS registry: the port's own copy of
``paddle_tpu/utils/flags.py``, so that ``PT_*`` and ``FLAGS_*``
variables mean the same in both packages."""
from __future__ import annotations

import os
from typing import Any

__all__ = ["define_flag", "get_flags", "set_flags", "FLAGS", "env_flag",
           "env_bool", "env_int", "env_float", "env_set", "env_str"]


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


def env_float(name: str, default: float) -> float:
    """A float env knob (the same lenient-empty / strict-malformed
    contract as :func:`env_int`)."""
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    return float(v.strip())


def env_str(name: str, default: str = "") -> str:
    """A ``PT_*`` string env knob (stripped)."""
    v = os.environ.get(name)
    return default if v is None else v.strip()


def env_set(name: str) -> bool:
    """Whether an env knob is PRESENT at all (even set-empty or "0"),
    for resolution orders where "explicitly set" beats other sources
    whatever the value."""
    return os.environ.get(name) is not None


_REGISTRY: dict[str, Any] = {}


def _env_cast(raw: str, default):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def define_flag(name: str, default, help_: str = ""):
    """Register ``name`` at ``default``, or at ``FLAGS_<name>`` from the
    environment cast to the default's type."""
    env = os.environ.get(f"FLAGS_{name}")
    _REGISTRY[name] = _env_cast(env, default) if env is not None else default


def get_flags(flags=None):
    if flags is None:
        return dict(_REGISTRY)
    if isinstance(flags, str):
        flags = [flags]
    return {f: _REGISTRY[f.replace("FLAGS_", "")] for f in flags}


def set_flags(flags: dict):
    for k, v in flags.items():
        _REGISTRY[k.replace("FLAGS_", "")] = v


class _Flags:
    def __getattr__(self, name):
        try:
            return _REGISTRY[name]
        except KeyError:
            raise AttributeError(name)


FLAGS = _Flags()

# the JAX package's core flags, under the same names and defaults
define_flag("allocator_strategy", "auto_growth")
define_flag("cudnn_deterministic", False)
define_flag("embedding_deterministic", 0)
define_flag("check_nan_inf", False)
define_flag("benchmark", False)
define_flag("use_flash_attention", True)
define_flag("log_level", 0)
define_flag("tpu_matmul_precision", "default")
