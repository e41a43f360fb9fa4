"""Compare the machine code (SASS) of the kernels that two CUDA sources build.

    python -m videoseal_tpu_torch.kernels.sass_diff OLD.cu NEW.cu --match NAME [--out DIR]

Compiles each source to a cubin with the library's nvcc flags, dumps its
SASS and resource usage with cuobjdump, and for every kernel whose mangled
name contains NAME prints its registers, its instruction count and the
opcodes whose counts differ, and the instructions before the first
tensor-core op (HMMA), up to the last, and after it. The dumps and a unified diff of each matched
kernel's instructions (addresses and encodings stripped) go to DIR
(default chiprun_out/sass). Needs nvcc and cuobjdump (the CUDA toolkit).
"""

from __future__ import annotations

import argparse
import collections
import difflib
import os
import re
import shutil
import subprocess

from ._lib import NVCC_FLAGS, _nvcc

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_RES = re.compile(r"Function (\S+):\s*\n?\s*REG:(\d+)")
# a kernel in an anonymous namespace: _ZN<length><namespace>..., where the
# namespace's name carries a hash of its file
_ANON = re.compile(r"_ZN(\d+)_GLOBAL__N_")


def _key(name: str) -> str:
    m = _ANON.match(name)
    if not m:
        return name
    return "_ZN11_GLOBAL__N_" + name[m.end(1) + int(m.group(1)):]


def _cuobjdump() -> str:
    path = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(path):
        raise RuntimeError("cuobjdump not found: it ships with the CUDA toolkit")
    return path


def dump(src: str, out_dir: str, tag: str) -> tuple[dict, dict]:
    """Build src to a cubin; return {kernel: [instructions]} and {kernel: registers}."""
    cubin = os.path.join(out_dir, f"{tag}.cubin")
    flags = [f for f in NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([_nvcc(), *flags, "-cubin", "-o", cubin, src], check=True,
                   capture_output=True, text=True)
    sass = subprocess.run([_cuobjdump(), "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    res = subprocess.run([_cuobjdump(), "-res-usage", cubin], check=True, capture_output=True,
                         text=True).stdout
    for ext, text in (("sass", sass), ("res", res)):
        with open(os.path.join(out_dir, f"{tag}.{ext}"), "w") as f:
            f.write(text)
    return parse(sass, res)


def parse(sass: str, res: str) -> tuple[dict, dict]:
    """cuobjdump's -sass and -res-usage text -> {kernel: [instructions]} and
    {kernel: registers}, the kernels keyed by their names without the
    anonymous namespace's per-file hash."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = _key(m.group(1))
            funcs[cur] = []
            continue
        m = _INSN.search(line)
        if cur and m:
            funcs[cur].append(re.sub(r"\s+", " ", m.group(1)))
    regs = {_key(name): int(r) for name, r in _RES.findall(res)}
    return funcs, regs


def _regions(insns: list[str]) -> tuple[int, ...]:
    idx = [j for j, i in enumerate(insns) if "HMMA" in i]
    if not idx:
        return (len(insns),)
    return idx[0], idx[-1] + 1 - idx[0], len(insns) - idx[-1] - 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--match", required=True)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "sass"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    old, old_regs = dump(args.old, args.out, "old")
    new, new_regs = dump(args.new, args.out, "new")
    for name in sorted(n for n in set(old) | set(new) if args.match in n):
        a, b = old.get(name, []), new.get(name, [])
        # the opcode, after a predicate such as @P0 or @!P1
        opc = lambda insns: collections.Counter(
            i.split(" ")[1 if i.startswith("@") else 0] for i in insns)
        ca, cb = opc(a), opc(b)
        changed = {k: (ca[k], cb[k]) for k in sorted(set(ca) | set(cb)) if ca[k] != cb[k]}
        print(f"{name}: registers {old_regs.get(name)} -> {new_regs.get(name)}, "
              f"instructions {len(a)} -> {len(b)}, identical {a == b}")
        print(f"  instructions before the first HMMA, to the last, after it: "
              f"{_regions(a)} -> {_regions(b)}")
        print(f"  opcodes whose counts differ (old, new): {changed}")
        with open(os.path.join(args.out, f"{name[:80]}.diff"), "w") as f:
            f.writelines(difflib.unified_diff([i + "\n" for i in a], [i + "\n" for i in b],
                                              "old", "new", n=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
