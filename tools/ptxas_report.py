"""Build the port's kernel library and print the compiler's register,
shared-memory and spill report (``-Xptxas -v``) for the kernels whose
names hold one of the given texts.

Usage, from the repository root (needs nvcc): python3 tools/ptxas_report.py
[TEXT ...]  (default: every kernel).
"""

from __future__ import annotations

import sys

sys.path.insert(0, ".")

from optix_ray_tracer_tpu_torch.ops.kernels import _lib  # noqa: E402


def main() -> None:
    _lib.load()
    if _lib.build_log is None:
        raise SystemExit("ptxas_report: the library was built before; no "
                         "report")
    print(f"[ptxas] built in {_lib.build_seconds:.1f} s")
    keep, entry = sys.argv[1:], None
    for line in _lib.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        if entry and (not keep or any(k in entry for k in keep)) and (
                "Used" in line or "spill" in line
                or "Compiling entry" in line):
            print(line.strip())


if __name__ == "__main__":
    main()
