"""Where a CUDA source's kernels touch local memory: every STL / LDL in
its SASS, with the function, the source line and the loops around it.

    python -m skred_tpu_torch.tools.sass_locals SOURCE.cu [-D NAME[=V]]...

The source is compiled with the port's nvcc flags (engine/kernels/
build.py) and ``-lineinfo`` into a cubin under ``build/sass_locals/``,
disassembled by ``nvdisasm -g``; ptxas' register and spill lines are
printed first.  A loop is a backward branch's span; each local access
is listed with the spans (in instructions) of the loops that hold it,
innermost first, or "outside every loop".  Needs the CUDA toolkit
(nvcc, nvdisasm), not a card.

``sass_functions`` and ``sass_loop`` read a built library's SASS
(cuobjdump) for the instruction counts a sample step that chip_smoke.py
and ``tools/mega_ablate.py`` print.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import shutil
import subprocess

from skred_tpu_torch.engine.kernels import build

OUT = build.BUILD_DIR.parent / "sass_locals"
_DROP = {"-shared", "-Xcompiler", "-fPIC"}


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not pathlib.Path(path).exists():
        raise RuntimeError(f"{name} not found: it comes with the CUDA "
                           "toolkit")
    return path


def compile_cubin(src: pathlib.Path, defines=()) -> tuple:
    """(cubin path, ptxas' report) of ``src`` under ``defines``."""
    OUT.mkdir(parents=True, exist_ok=True)
    cubin = OUT / (src.stem + ".cubin")
    flags = [f for f in build.NVCC_FLAGS if f not in _DROP]
    res = subprocess.run(
        [_tool("nvcc"), *flags, *("-D" + d for d in defines), "--cubin",
         "-lineinfo", "-I", str(build.CSRC), "-o", str(cubin), str(src)],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError("nvcc failed:\n" + res.stderr)
    return cubin, res.stdout + res.stderr


def sass_functions(so) -> dict:
    """{kernel name: [(address, instruction)]} of a library, by
    cuobjdump -sass."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for part in re.split(r"\n\s+Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        out[name] = [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
    return out


def sass_loop(so, kernel, samples, first=None) -> dict:
    """Instructions of ``kernel``'s sample loop per sample step.  With
    ``samples`` > 1 (the keyed build's chunks) the first loop of at least
    4 x ``samples`` instructions: the fast pass's steady chunk loop;
    ``first``: the first loop of at least that many instructions (the
    keyed cyclic build's frame loop, a frame a pass).  Otherwise (a
    kernel without chunks, as the lookup's) its largest loop, counted
    statically, every run-time branch included."""
    funcs = sass_functions(so)
    name = next(nm for nm in funcs if kernel in nm)
    ins = funcs[name]
    loops = []
    for a, t in ins:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", t)
        if m and int(m.group(1), 16) < a:
            lo = int(m.group(1), 16)
            loops.append((lo, a, sum(1 for aa, _ in ins if lo <= aa <= a)))
    least = first if first is not None \
        else 4 * samples if samples > 1 else None
    big = [lp for lp in loops if least is not None and lp[2] >= least]
    lo, hi, count = min(big) if big else max(loops, key=lambda lp: lp[2])
    return dict(kernel=name, instructions=len(ins), loop=count,
                per_sample=count / samples)


def local_accesses(listing: str) -> list:
    """[(function, address, source line, instruction, [loop spans])]
    of every STL / LDL in an ``nvdisasm -g`` listing."""
    funcs = []                       # (name, [(addr, text, src)], labels)
    src = ""
    pending = []
    for line in listing.splitlines():
        m = re.match(r"^\.text\.(\S+):", line)
        if m:
            funcs.append((m.group(1), [], {}))
            src, pending = "", []
            continue
        if not funcs:
            continue
        m = re.search(r'//## File "([^"]+)", line (\d+)', line)
        if m:
            src = f"{pathlib.Path(m.group(1)).name}:{m.group(2)}"
            continue
        m = re.match(r"^(\.L_x_\d+):", line.strip())
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                funcs[-1][2][lab] = addr
            pending = []
            funcs[-1][1].append((addr, m.group(2).strip(), src))
    found = []
    for name, ins, labels in funcs:
        loops = []
        for addr, text, _ in ins:
            m = re.search(r"\bBRA\b.*\((\.L_x_\d+)\)", text)
            if m and labels.get(m.group(1), addr) < addr:
                loops.append((labels[m.group(1)], addr))
        for addr, text, where in ins:
            if re.match(r"^(@!?P\d+\s+)?(STL|LDL)\b", text):
                spans = sorted(sum(1 for a, _, _ in ins if lo <= a <= hi)
                               for lo, hi in loops if lo <= addr <= hi)
                found.append((name, addr, where, text, spans))
    return found


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", type=pathlib.Path)
    ap.add_argument("-D", dest="defines", action="append", default=[])
    args = ap.parse_args(argv)
    cubin, report = compile_cubin(args.source, args.defines)
    for line in report.splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print(line.strip())
    listing = subprocess.run([_tool("nvdisasm"), "-g", "-c", str(cubin)],
                             capture_output=True, text=True,
                             check=True).stdout
    found = local_accesses(listing)
    for name, addr, where, text, spans in found:
        inside = ("in loops of " + ", ".join(map(str, spans))
                  + " instructions" if spans else "outside every loop")
        print(f"{name} /*{addr:04x}*/ {where}: {text}; {inside}")
    print(f"{len(found)} local-memory instruction(s) in {args.source.name}")


if __name__ == "__main__":
    main()
