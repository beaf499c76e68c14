#!/usr/bin/env python3
"""Read the machine code (SASS) of the port's hand-written `wgmma` kernels
for register hazards, spills and how they reach shared memory.

    python3 sass_check.py [SOURCE ...]

Each SOURCE (a file of src/repro_torch/csrc, or a path to a patched copy;
default: flash_attention_bwd_tf32_sm90.cu) is compiled for sm_90a with the
build's flags (`_lib.FLAGS`, `-I` the csrc directory) to a cubin and
disassembled with `cuobjdump -sass` into chiprun_out/sass/<name>.sass. For
each kernel it prints:

  hgmma      the `wgmma` instructions (HGMMA)
  hazards    instructions between an HGMMA's issue and the next full wait
             (WARPGROUP.DEPBAR ... 0x0) that write a register the HGMMA
             reads as its A fragment or writes as its accumulator, or that
             read its accumulator (a linear scan of the listing: a loop's
             back edge is not followed)
  spills     spill stores and loads (STL / LDL), and those inside the
             windows above
  shared     loads and stores that name shared memory (LDS, STS, LDSM)
  generic    generic loads and stores (LD, ST): each takes a 64-bit address,
             two registers, where a shared-memory tile is reached through a
             pointer the compiler could not place in shared memory

and the compiler's warnings (spills, `wgmma` serialized).

Exits 1 if a kernel has a hazard. Needs the CUDA toolkit (nvcc, cuobjdump),
not a GPU; imports nothing of JAX.
"""
from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
REG = re.compile(r"^R(\d+)$")
# opcodes whose first operands are predicates and that write no register
PRED_ONLY = ("ISETP", "FSETP", "DSETP", "HSETP2", "PLOP3", "R2P", "VOTEU")
NO_DEST = ("ST", "BAR", "BRA", "BSYNC", "BSSY", "EXIT", "MEMBAR", "FENCE",
           "WARPSYNC", "NOP", "SYNCS", "UTMA", "UBLKCP", "RED", "CCTL",
           "ERRBAR", "DEPBAR", "CALL", "RET", "YIELD", "WARPGROUP")


def _width(op: str) -> int:
    """Registers a load or a wide multiply writes."""
    if ".128" in op:
        return 4
    if ".64" in op or ".WIDE" in op:
        return 2
    return 1


def _operands(ins: str) -> tuple:
    body = re.sub(r"^@!?U?P\w+\s+", "", ins.strip())
    parts = body.split(None, 1)
    ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 else []
    return parts[0] if parts else "", ops


def _regs(operand: str) -> list:
    return [int(r) for r in re.findall(r"\bR(\d+)\b", operand)]


def scan(listing: str) -> dict:
    """{kernel: counts} from `cuobjdump -sass` output."""
    out = {}
    for chunk in re.split(r"\n\s*Function : ", listing)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        c = dict(hgmma=0, hazards=[], spill_st=0, spill_ld=0,
                 spills_in_flight=0, shared=0, generic=0)
        live = {}  # register -> "A" or "accumulator" of an HGMMA in flight
        for m in INSTR.finditer(chunk):
            addr, ins = m.group(1), m.group(2)
            op, ops = _operands(ins)
            if op.startswith("HGMMA"):
                c["hgmma"] += 1
                n = int(re.match(r"HGMMA\.\d+x(\d+)x", op).group(1))
                d = REG.match(ops[0])
                for r in range(int(d.group(1)), int(d.group(1)) + n // 2):
                    live[r] = "accumulator"
                a = REG.match(ops[1])
                if a:
                    for r in range(int(a.group(1)), int(a.group(1)) + 4):
                        live.setdefault(r, "A")
                continue
            if op.startswith("WARPGROUP.DEPBAR"):
                if ops and ops[-1] == "0x0":
                    live = {}
                continue
            if op in ("STL", "LDL") or op.startswith(("STL.", "LDL.")):
                c["spill_st" if op.startswith("STL") else "spill_ld"] += 1
                c["spills_in_flight"] += bool(live)
            elif op.startswith(("LDS", "STS")):
                c["shared"] += 1
            elif re.match(r"^(LD|ST)(\.|$)", op):
                c["generic"] += 1
            if not live:
                continue
            dest = []
            if not op.startswith(PRED_ONLY + NO_DEST):
                rest = list(ops)
                while rest and re.match(r"^!?U?P(T|\d+)$", rest[0]):
                    rest.pop(0)
                if rest and REG.match(rest[0]):
                    r0 = int(REG.match(rest[0]).group(1))
                    w = _width(op) if op.startswith(("LD", "IMAD", "MOV")) \
                        else 1
                    dest = list(range(r0, r0 + w))
                    rest = rest[1:]
                srcs = [r for o in rest for r in _regs(o)]
            else:
                srcs = [r for o in ops for r in _regs(o)]
            for r in dest:
                if r in live:
                    c["hazards"].append(f"{addr}: {ins.strip()} writes R{r}, "
                                        f"{live[r]} of an HGMMA in flight")
            for r in srcs:
                if live.get(r) == "accumulator":
                    c["hazards"].append(f"{addr}: {ins.strip()} reads R{r}, "
                                        "accumulator of an HGMMA in flight")
        out[name] = c
    return out


def _short(name: str) -> str:
    """fa_bwd_dq_tf32<128> of a mangled `_ZN<len><name>...ILi128E...`."""
    i, last = (3, None) if name.startswith("_ZN") else (len(name), name)
    while i < len(name) and name[i].isdigit():
        j = i
        while name[j].isdigit():
            j += 1
        last, i = name[j:j + int(name[i:j])], j + int(name[i:j])
    m = re.match(r"ILi(\d+)E", name[i:])
    return f"{last}<{m.group(1)}>" if m else last


def main(argv: list) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _lib

    nvcc = _lib._nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    flags = [f for f in _lib.FLAGS if f not in ("-Xcompiler", "-fPIC")]
    out_dir = ROOT / "chiprun_out" / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    bad = 0
    for src in argv or ["flash_attention_bwd_tf32_sm90.cu"]:
        path = Path(src) if Path(src).is_file() else CSRC / src
        with tempfile.TemporaryDirectory() as tmp:
            cubin = Path(tmp) / "k.cubin"
            built = subprocess.run([nvcc, *flags, "-I", str(CSRC), "-cubin",
                                    str(path), "-o", str(cubin)], check=True,
                                   capture_output=True, text=True)
            listing = subprocess.run([cuobjdump, "-sass", str(cubin)],
                                     check=True, capture_output=True,
                                     text=True).stdout
        (out_dir / f"{path.name}.sass").write_text(listing)
        print(f"== {path}", flush=True)
        for line in (built.stdout + built.stderr).splitlines():
            if "warning" in line or "Performance Loss" in line:
                print(f"  ptxas: {line.strip()}")
        for name, c in scan(listing).items():
            bad += bool(c["hazards"])
            print(f"{_short(name)}: hgmma {c['hgmma']}, hazards "
                  f"{len(c['hazards'])}, spills {c['spill_st']} STL / "
                  f"{c['spill_ld']} LDL ({c['spills_in_flight']} with an "
                  f"HGMMA in flight), shared {c['shared']}, generic "
                  f"{c['generic']}")
            for h in c["hazards"][:20]:
                print(f"  {h}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
