"""Compare this checkout's decode kernels with another checkout's on one
card: their outputs bit for bit on the same inputs, and their device times
in alternating turns.

    python3 decode_ab.py OTHER [--rounds N] [--out F]

OTHER is the root of another checkout of the repository (a parent commit
unpacked by ``git archive``). Each side runs in processes of its own, with
its own package on the path and its kernels built from its own sources
(nothing of one side is called through the other's bindings). On inputs
drawn from one seed on the host, each side runs the decode kernel's
default mode (``gqa_decode_attention_cuda``) at the serve phase's shapes
(B 8, 16 / 8 heads of 128, Smax 512, bf16, the engine's cache layout), at
a rank's local heads (1, 1) / (2, 1) / (3, 1) over B 8, Smax 4,096 of
ragged kv_len (bf16), and in f32 at 16 / 8 heads of 128 with rows of
kv_len 0 and past Smax; and the paged kernel (``paged_gqa_decode_
attention_cuda``) at B 8, 16 / 8 heads of 128, blocks of 16. The outputs
are compared bit for bit between the sides. Then, in turns (other, this,
this, other, for ``--rounds`` rounds), the default mode's median device
time over 20 calls (``chip_smoke.device_kernel_ms``) at each shape.
Prints the card's name and power limit, one JSON line a shape with each
side's median in ms and whether the outputs are bit for bit equal, and a
last line with every verdict; ``--out`` gets them all.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: (name, B, Hq, Hkv, D, Smax, kv_len, dtype, the engine's layout)
DECODE_SHAPES = (
    ("serve", 8, 16, 8, 128, 512, (42, 64, 80, 99, 100, 111, 120, 127),
     "bfloat16", True),
    ("local_1_1", 8, 1, 1, 128, 4096,
     (4096, 1, 1000, 4095, 17, 2048, 3333, 512), "bfloat16", False),
    ("local_2_1", 8, 2, 1, 128, 4096,
     (4096, 1, 1000, 4095, 17, 2048, 3333, 512), "bfloat16", False),
    ("local_3_1", 8, 3, 1, 128, 4096,
     (4096, 1, 1000, 4095, 17, 2048, 3333, 512), "bfloat16", False),
    ("f32_edges", 4, 16, 8, 128, 520, (0, 520, 700, 129), "float32", True),
)
#: (name, B, Hq, Hkv, D, n_blocks, block_size, max_blocks, kv_len)
PAGED_SHAPES = (("paged", 8, 16, 8, 128, 96, 16, 24,
                 (144, 256, 200, 160, 1, 0, 383, 300)),)


def _side_modules(side: Path):
    """The side's own decode and paged wrappers (its package first on the
    path), then this checkout's ``chip_smoke`` for its profiler helpers."""
    sys.path[:0] = [str(side / "src"), str(HERE)]
    from repro_torch.kernels import decode_attention, paged_attention
    import chip_smoke
    assert Path(decode_attention.__file__).resolve().is_relative_to(
        side.resolve()), decode_attention.__file__
    return decode_attention, paged_attention, chip_smoke


def _decode_args(shape):
    """q (B, Hq, D), a (B, Hkv, Smax, D) view of the cache (one layer of
    the engine's (B, Smax, Hkv, D) cache permuted, or contiguous) and
    kv_len, drawn on the host from one seed and moved to the card."""
    import torch
    _, B, Hq, Hkv, D, Smax, lens, dtype, engine = shape
    gen = torch.Generator().manual_seed(Hq * 1000 + Smax)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Hq, D), generator=gen).to(dt).cuda()
    kv = [torch.randn((B, Smax, Hkv, D) if engine else (B, Hkv, Smax, D),
                      generator=gen).to(dt).cuda() for _ in range(2)]
    if engine:
        kv = [t.permute(0, 2, 1, 3) for t in kv]
    return (q, *kv, torch.tensor(lens, dtype=torch.int32, device="cuda"))


def _paged_args(shape):
    import torch
    _, B, Hq, Hkv, D, nb, bs, mb, lens = shape
    gen = torch.Generator().manual_seed(nb * 100 + bs)
    q = torch.randn((B, Hq, D), generator=gen).to(torch.bfloat16).cuda()
    pools = [torch.randn((nb, bs, Hkv, D), generator=gen)
             .to(torch.bfloat16).cuda().permute(0, 2, 1, 3)
             for _ in range(2)]
    bt = torch.randint(-1, nb, (B, mb), generator=gen,
                       dtype=torch.int32).cuda()
    return (q, *pools, bt, torch.tensor(lens, dtype=torch.int32,
                                        device="cuda"))


def side_outputs(side: Path, out: Path) -> dict:
    """Each shape's output saved under ``out`` (a .pt of host tensors)."""
    import torch
    dec, paged, _ = _side_modules(side)
    got = {s[0]: dec.gqa_decode_attention_cuda(*_decode_args(s)).cpu()
           for s in DECODE_SHAPES}
    got.update({s[0]: paged.paged_gqa_decode_attention_cuda(
        *_paged_args(s)).cpu() for s in PAGED_SHAPES})
    torch.save(got, out)
    return {"saved": str(out)}


def side_times(side: Path) -> dict:
    """{shape: the default mode's median device ms} of one turn."""
    dec, _, chip_smoke = _side_modules(side)
    return {s[0]: chip_smoke.device_kernel_ms(
        dec.gqa_decode_attention_cuda, *_decode_args(s),
        name=chip_smoke.DECODE_KERNEL) for s in DECODE_SHAPES}


def _in_side(mode: str, side: Path, out: Path):
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--side", mode, str(side), str(out)], cwd=side,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{mode} on {side} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _bits_equal(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--side", nargs=3, metavar=("MODE", "ROOT", "OUT"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.side:
        mode, root, out = a.side[0], Path(a.side[1]), Path(a.side[2])
        print(json.dumps(side_outputs(root, out) if mode == "outputs"
                         else side_times(root)))
        return 0
    if a.other is None:
        ap.error("OTHER, another checkout's root, is required")
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    sides = {"other": a.other.resolve(), "this": HERE}
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        outs = {}
        for name, root in sides.items():
            _in_side("outputs", root, Path(tmp) / f"{name}.pt")
            outs[name] = torch.load(Path(tmp) / f"{name}.pt")
    turns = {name: [] for name in sides}
    order = list(sides) + list(sides)[::-1]
    for _ in range(a.rounds):
        for name in order:
            turns[name].append(_in_side("times", sides[name], Path("-")))
    equal = {}
    for shape in DECODE_SHAPES + PAGED_SHAPES:
        key = shape[0]
        equal[key] = _bits_equal(outs["other"][key], outs["this"][key])
        row = {"shape": key, "bit_equal": equal[key], "card": smi}
        if key in turns["this"][0]:
            for name in sides:
                vals = [t[key] for t in turns[name] if t[key] is not None]
                row[f"{name}_device_ms"] = (statistics.median(vals)
                                            if vals else None)
        rows.append(row)
        print(json.dumps(row), flush=True)
    rows.append({"bit_equal": equal, "all": all(equal.values())})
    print(json.dumps(rows[-1]), flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(rows, indent=1))
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
