"""Build variants of a kernel source and report what ptxas made of them.

    python -m anakin_tpu_torch.tools.kernel_variants SOURCE PATTERN STUDY.json
        [--only NAME,...] [--watchdog] [--check] [--timed]

SOURCE names a file of `csrc/` without `.cu` (for example
`flash_attention`).  STUDY.json holds `variants`, a map of a variant's
name to its edits, and `rows` (for `--check`); `--only` takes some of
the variants.  An edit `old=>new`
substitutes text in the source and the headers of `csrc/`
(each must match somewhere), an edit starting with `-` is a compiler flag
(`-DNAME`, `-Xptxas=...`); the variant with no edits is the source as it is.
Every variant is compiled at once with the port's nvcc flags into
`build/kernel_variants/<name>/`.  For every kernel whose mangled name
contains PATTERN the script prints ptxas's registers, stack frame and
spills, its C75xx notes (wgmma serialized, setmaxnreg ignored), and from
the SASS (cuobjdump) the highest register a kernel uses and its local-memory
loads and stores.

`--watchdog` bounds every mbarrier wait of `hopper.cuh` (a trap after 2^22
polls), so that a deadlocked protocol fails its launch instead of hanging
it.  `--check` (flash_attention only, on a CUDA card) then loads each
variant as the flash_attention library and holds it to its plain version
at each of the study's rows, `[B, H, Hkv, S, D, causal, lengths, Sk]` in bf16,
through `chip_smoke.check_flash` (run from the repository's root); with
`--timed` each row is timed beside SDPA.  Needs nvcc: the machine with the
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from ..kernels import _build

OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "kernel_variants")
WATCHDOG = ("  while (!done)\n",
            "  for (long long n_ = 0; !done; ++n_)\n"
            "    if (n_ > (1ll << 22)) asm volatile(\"trap;\"); else\n")


def make_variant(name: str, edits, source: str, watchdog: bool):
    """Copy `csrc/` to the variant's directory with its text edits applied;
    returns (the .cu path, the extra compiler flags)."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    files = {f: open(os.path.join(d, f)).read() for f in os.listdir(d)
             if f.endswith(".cuh") or f == source + ".cu"}
    if watchdog:
        assert WATCHDOG[0] in files["hopper.cuh"], "hopper.cuh's mbar_wait changed"
        files["hopper.cuh"] = files["hopper.cuh"].replace(*WATCHDOG)
    flags = []
    for edit in edits:
        if edit.startswith("-"):
            flags.append(edit)
            continue
        old, new = edit.split("=>")
        hit = [f for f, text in files.items() if old in text]
        if not hit:
            raise ValueError(f"variant {name}: no file holds {old!r}")
        for f in hit:
            files[f] = files[f].replace(old, new)
    for f, text in files.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    return os.path.join(d, source + ".cu"), flags


def compile_variant(name, src, flags):
    lib = os.path.join(OUT, name + ".so")
    t0 = time.perf_counter()
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", lib, src],
                       capture_output=True, text=True)
    return lib, p.returncode, p.stdout + p.stderr, time.perf_counter() - t0


def ptxas_report(log: str, pattern: str):
    """(kernel, 'N registers, stack / spills') of each matching kernel, and
    the C75xx notes about any of them."""
    rows, notes, name = [], [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and pattern in name and "stack frame" in line:
            rows.append([name, line.strip()])
        elif name and pattern in name and "Used" in line and rows:
            rows[-1][1] += " | " + line.split(":", 1)[1].strip()
        if re.search(r"\(C75\d\d\)", line) and pattern in line:
            notes.append(re.search(r"\(C75\d\d\)[^']*", line).group(0).strip())
    return rows, notes


def sass_report(lib: str, pattern: str):
    """{kernel: (instructions, highest register, LDL, STL)} from cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run([os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump"),
                           "-sass", lib], capture_output=True, text=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        fn = part.split()[0]
        if pattern not in fn:
            continue
        ins = [l for l in part.splitlines() if re.match(r"\s*/\*[0-9a-f]{4,}\*/", l)]
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", part)]
        out[fn] = (len(ins), max(regs) if regs else -1, sum("LDL" in l for l in ins),
                   sum("STL" in l for l in ins))
    return out


def check_rows(lib: str, tag: str, rows, timed: bool) -> int:
    """Holds the flash_attention library `lib` to its plain version at each
    row; returns the number of rows that differ."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs

    _build._loaded["flash_attention"] = ctypes.CDLL(lib)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    bad = 0
    for B, H, Hkv, S, D, causal, lengths, Sk in rows:
        r = cs.check_flash(B, H, Hkv, S, D, torch.bfloat16, causal, lengths, gen, 0,
                           timed=timed, Sk=Sk)
        bad += not r["ok"]
        line = (f"[{tag}] {[B, H, Hkv, S, D]} Sk={Sk} causal={causal} lengths={lengths} "
                f"route={r['route']} ok={r['ok']} err={r['max_abs_err']:.3g}")
        if timed:
            line += (f" ms={r['ms']:.4f} sdpa={r['library_ms']:.4f} "
                     f"bound={r['bound_ms']:.4f} ({r['bound_ms'] / r['ms']:.1%})")
        print(line, flush=True)
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source")
    ap.add_argument("pattern")
    ap.add_argument("study")
    ap.add_argument("--only", default=None)
    ap.add_argument("--watchdog", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--timed", action="store_true")
    args = ap.parse_args(argv)
    with open(args.study) as f:
        study = json.load(f)
    variants = study["variants"]
    if args.only:
        variants = {n: variants[n] for n in args.only.split(",")}
    os.makedirs(OUT, exist_ok=True)
    made = {name: make_variant(name, edits, args.source, args.watchdog)
            for name, edits in variants.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(made)) as pool:
        built = dict(zip(made, pool.map(lambda n: compile_variant(n, *made[n]), made)))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    failed = 0
    for name, (lib, rc, log, secs) in built.items():
        print(f"=== {name}: nvcc rc {rc}, {secs:.1f} s", flush=True)
        if rc:
            print(log[-3000:])
            failed += 1
            continue
        rows, notes = ptxas_report(log, args.pattern)
        sass = sass_report(lib, args.pattern)
        for fn, info in rows:
            n, top, ldl, stl = sass.get(fn, (0, -1, 0, 0))
            print(f"  {fn}: {info}; SASS {n} instructions, highest R{top}, "
                  f"LDL {ldl}, STL {stl}")
        for note in sorted(set(notes)):
            print(f"  note {note} ({notes.count(note)} x)")
    if args.check:
        for name, (lib, rc, _, _) in built.items():
            if rc == 0:
                failed += check_rows(lib, name, study["rows"], args.timed) > 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
