"""Host-only helpers of the port (no device code)."""
from .flags import env_bool, env_flag, env_int

__all__ = ["env_bool", "env_flag", "env_int"]
