"""Host-only helpers of the port (no device code)."""
from .flags import (FLAGS, define_flag, env_bool, env_flag, env_float,
                    env_int, env_set, env_str, get_flags, set_flags)

__all__ = ["FLAGS", "define_flag", "env_bool", "env_flag", "env_float",
           "env_int", "env_set", "env_str", "get_flags", "set_flags"]
