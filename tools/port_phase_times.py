"""Run ``chip_smoke.py`` with every phase's wall time printed.

Each kernel check (``check_*``) and each path (``*_path``) of the script
is wrapped so that it prints ``[phase-time] <name> <seconds> s`` when it
returns, and the whole run prints ``[phase-time] total <seconds> s``.
The script itself runs unchanged. Run it from the root of the repo:

    python3 tools/port_phase_times.py
"""

import functools
import os
import sys
import time


def _timed(name, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            print(f"[phase-time] {name} {time.perf_counter() - t0:.1f} s",
                  flush=True)
    return run


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    sys.argv = [os.path.join(root, "chip_smoke.py")]
    import chip_smoke

    for name, fn in list(vars(chip_smoke).items()):
        if callable(fn) and (name.endswith("_path") or name.startswith("check_")
                             or name == "rms_residual_entry"):
            setattr(chip_smoke, name, _timed(name, fn))
    t0 = time.perf_counter()
    rc = chip_smoke.main()
    print(f"[phase-time] total {time.perf_counter() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
