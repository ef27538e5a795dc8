"""Which kernel instances of two builds of csrc/column_pass.cu compile to the
same machine code.

    python -m cpp_fluid_particles_tpu_torch.exp.sass_compare OLD.so NEW.so \\
        [--out FILE.json]

Each library (``column_pass_cuda.build()`` of a tree: the parent's and a
change's) is disassembled with ``cuobjdump -sass``; every kernel entry's
SASS, with the addresses and encodings cut, is compared by its mangled
name. nvcc names the source's anonymous namespace after a hash that
differs from build to build (``_GLOBAL__N__<hash>_14_column_pass_cu_...``),
so the hash is cut from names and instructions alike. Prints per kernel
template (``particle_pass_kernel``, ``record_pass_kernel``,
``pack_kernel``, ``counted_pass_kernel``, ``count_pack_kernel``, ...) how many entries are the same, changed, only in OLD
and only in NEW, then the changed entries by name, and writes the same as
JSON to ``--out``. It needs the CUDA toolkit's ``cuobjdump`` (on the
PATH or under /usr/local/cuda/bin).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

KERNELS = ("particle_pass_kernel", "record_pass_kernel", "pack_kernel",
           "counted_pass_kernel", "count_pack_kernel", "column_pass_kernel",
           "flat_pass_kernel")


def cuobjdump() -> str:
    path = shutil.which("cuobjdump")
    if path is None and os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        path = "/usr/local/cuda/bin/cuobjdump"
    if path is None:
        raise SystemExit("sass_compare needs cuobjdump (the CUDA toolkit)")
    return path


def entries(text: str) -> dict:
    """``cuobjdump -sass`` output -> {mangled entry: its instructions, one
    string, without addresses, encodings and the namespace's hash}."""
    out, name, body = {}, None, []
    for line in text.splitlines():
        line = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", line)
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name is not None:
                out[name] = "\n".join(body)
            name, body = m.group(1), []
            continue
        if name is None:
            continue
        ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)     # address
        ins = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", ins)      # encoding
        ins = ins.strip()
        if ins and not ins.startswith(("..", "//")):
            body.append(ins)
    if name is not None:
        out[name] = "\n".join(body)
    return out


def sass(lib: Path) -> dict:
    proc = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True)
    return entries(proc.stdout)


def kernel_of(name: str) -> str:
    return next((k for k in KERNELS if f"{len(k)}{k}" in name), "other")


def compare(old: dict, new: dict) -> dict:
    """-> {kernel: {"same", "changed", "only_old", "only_new": [names]}}"""
    report = {}
    for name in sorted(set(old) | set(new)):
        if name not in new:
            what = "only_old"
        elif name not in old:
            what = "only_new"
        else:
            what = "same" if old[name] == new[name] else "changed"
        report.setdefault(kernel_of(name), {
            "same": [], "changed": [], "only_old": [], "only_new": []})[
                what].append(name)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    report = compare(sass(Path(args.old)), sass(Path(args.new)))
    for kernel, r in report.items():
        print(f"[sass] {kernel}: " + ", ".join(
            f"{k} {len(v)}" for k, v in r.items()), flush=True)
        for name in r["changed"]:
            print(f"[sass]   changed {name}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
