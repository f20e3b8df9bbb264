"""Compare this checkout's flash-attention kernels with another checkout's on
one card: their builds, and their device times in alternating turns.

    python3 flash_ab.py OTHER [--rounds N] [--out F]

OTHER is the root of another checkout of the repository (a parent commit
unpacked by ``git archive``, or a patched copy of this tree). Both sides'
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` are
compiled alone, with this checkout's nvcc flags and ``-Xptxas -v``: each
kernel's registers, spill bytes and ptxas notes of a performance loss
(``wgmma`` serialized, C7514 / C7515), and a hash of its SASS from
``cuobjdump -sass``, so that a change meant to leave a kernel's machine
code alone shows that it did. Then each side runs in processes of its own,
with its own package on the path and its own kernels built from its own
sources (nothing of one side is called through the other's bindings):
first a check of its forward and backward against the plain versions
(bf16 within 2e-2, the backward's gradients of max|g|, two backward calls
bit for bit), then, in turns (other, this, this, other, for ``--rounds``
rounds), each kernel's median device time over 20 calls
(``chip_smoke.device_kernel_ms``) at the forward's shapes (B 1, 16 / 8
heads of 128, causal S 128 and 512; whisper's 6 heads of 64, non-causal
S 1,504) and the backward's (B 4 and B 1, 16 / 8 heads of 128, causal S
128 and 1,024). Prints the card's name and power limit, one JSON line a
side for its build, one for the forward's SASS compared, and one a (shape,
side) with the medians over the rounds in ms; ``--out`` gets them all.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu")
#: (name, B, Hq, Hkv, D, S, causal)
FORWARD_SHAPES = (("fwd_s128", 1, 16, 8, 128, 128, True),
                  ("fwd_s512", 1, 16, 8, 128, 512, True),
                  ("fwd_s1504", 1, 6, 6, 64, 1504, False))
BACKWARD_SHAPES = (("bwd_s128", 4, 16, 8, 128, 128, True),
                   ("bwd_s1024", 1, 16, 8, 128, 1024, True))
#: profiled-name substrings of the kernels timed, by pass
KERNELS = {"fwd": ("flash_attention_kernel",),
           "bwd": ("flash_bwd_dq", "flash_bwd_dkdv")}
TOL = 2e-2


def csrc_of(root: Path) -> Path:
    """The kernel sources of a checkout root."""
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    if not all((csrc / s).is_file() for s in SOURCES):
        raise FileNotFoundError(f"no {' and '.join(SOURCES)} under {csrc}")
    return csrc


def kernel_label(mangled: str):
    """``name<args>`` of a kernel's mangled name (``flash_...``, its
    length-prefixed identifier, and integer or float template arguments),
    or None for a name that holds no flash kernel."""
    for m in re.finditer(r"(\d{2})(flash_\w+)", mangled):
        n = int(m.group(1))
        name, rest = m.group(2)[:n], m.group(2)[n:]
        if len(name) == n and rest[:1] in ("I", "E"):
            break
    else:
        return None
    t = re.match(r"I((?:Li\d+E|f|13__nv_bfloat16)+)E", rest)
    if t is None:
        return name
    args = re.findall(r"Li(\d+)E|(f)|(13__nv_bfloat16)", t.group(1))
    return name + "<" + ", ".join(
        i or ("float" if f else "bf16") for i, f, _ in args) + ">"


def ptxas_stats(stderr: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads", "notes"}} from
    ``nvcc -Xptxas -v``'s report; "notes" holds the lines that report a
    performance loss (``wgmma`` serialized: C7514, C7515)."""
    stats, name = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
            if name is not None:
                stats[name] = {"notes": []}
            continue
        if name is None:
            continue
        if "Performance Loss" in line or "C75" in line:
            stats[name]["notes"].append(line.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            stats[name]["spill_stores"] = int(m.group(1))
            stats[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            stats[name]["registers"] = int(m.group(1))
    return stats


def sass_hashes(sass: str) -> dict:
    """{kernel: sha256 of its SASS} from ``cuobjdump -sass``'s listing:
    every instruction and encoding of a function, whitespace collapsed and
    the anonymous namespace's per-build hash left out."""
    out, name, body = {}, None, []

    def close():
        if name is not None:
            out[name] = hashlib.sha256("\n".join(body).encode()).hexdigest()

    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            close()
            name, body = kernel_label(m.group(1)), []
            continue
        if name is not None and line.strip().startswith("/*"):
            body.append(re.sub(r"_GLOBAL__N__[0-9a-f]+", "_GLOBAL__N__",
                               " ".join(line.split())))
    close()
    return out


def build_report(csrc: Path, out_dir: Path) -> dict:
    """Both sources of ``csrc`` compiled alone into ``out_dir``:
    {source: {"ptxas": ptxas_stats, "sass": sass_hashes}}."""
    from repro_torch.kernels import _build
    nvcc = _build.find_nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    procs = {}
    for src in SOURCES:
        cmd = _build.compile_command(nvcc, csrc / src, out_dir / f"{src}.o")
        procs[src] = subprocess.Popen(cmd[:1] + ["-Xptxas", "-v"] + cmd[1:],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
    report = {}
    for src, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / src}:\n{err}")
        sass = subprocess.run([cuobjdump, "-sass", str(out_dir / f"{src}.o")],
                              capture_output=True, text=True, check=True)
        report[src] = {"ptxas": ptxas_stats(err),
                       "sass": sass_hashes(sass.stdout)}
    return report


def sass_compared(a: dict, b: dict) -> dict:
    """{kernel: whether both sides have it with the same SASS}."""
    return {k: a.get(k) == b.get(k) for k in sorted(set(a) | set(b))}


# ---------------------------------------------------------------------------
# a side's own process
# ---------------------------------------------------------------------------

def _side_modules(side: Path):
    """The side's own ``flash_attention`` and ``ref`` (its package first on
    the path), then this checkout's ``chip_smoke`` for its profiler
    helpers."""
    sys.path[:0] = [str(side / "src"), str(HERE)]
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    import chip_smoke
    assert Path(fa.__file__).resolve().is_relative_to(side.resolve()), \
        fa.__file__
    return fa, ref, chip_smoke


def _calls(fa, chip_smoke, shape):
    """(pass, fn, args) of a shape on the card: the forward, or the
    backward on the forward's output and lse."""
    import torch
    kind, B, Hq, Hkv, D, S, causal = shape
    q, k, v, do = chip_smoke._bwd_inputs(B, Hq, Hkv, D, S, torch.bfloat16,
                                         torch.Generator().manual_seed(5))
    if kind.startswith("fwd"):
        return "fwd", fa.flash_attention_cuda, (q, k, v, causal)
    out, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
    return "bwd", fa.flash_attention_backward_cuda, (q, k, v, out, lse, do,
                                                     causal)


def side_check(side: Path) -> dict:
    """{shape: largest error over the tolerance's scale}: the forward
    against ``ref.mha_prefill`` (absolute), the backward's gradients
    against ``ref.flash_attention_backward_ref`` (over each max|g|), two
    backward calls bit for bit. Raises past TOL."""
    import torch
    fa, ref, chip_smoke = _side_modules(side)
    out = {}
    for shape in FORWARD_SHAPES + BACKWARD_SHAPES:
        kind, fn, args = _calls(fa, chip_smoke, shape)
        got = fn(*args)
        if kind == "fwd":
            err = float((got.float() - ref.mha_prefill(*args).float())
                        .abs().max())
            assert err <= TOL, (shape, err)
            out[shape[0]] = err
            continue
        q, k, v, o, _, do, causal = args
        assert all(torch.equal(a, b) for a, b in zip(got, fn(*args))), \
            ("two calls differ", shape)
        worst = 0.0
        for g, w in zip(got, ref.flash_attention_backward_ref(q, k, v, o, do,
                                                              causal)):
            scale = float(w.float().abs().max())
            err = float((g.float() - w.float()).abs().max())
            assert err <= TOL * scale, (shape, err, scale)
            worst = max(worst, err / scale)
        out[shape[0]] = worst
    return out


def side_times(side: Path) -> dict:
    """{shape: {kernel: median device ms}} of one turn."""
    fa, _, chip_smoke = _side_modules(side)
    out = {}
    for shape in FORWARD_SHAPES + BACKWARD_SHAPES:
        kind, fn, args = _calls(fa, chip_smoke, shape)
        out[shape[0]] = {name: chip_smoke.device_kernel_ms(fn, *args,
                                                           name=name)
                         for name in KERNELS[kind]}
    return out


def _in_side(mode: str, side: Path):
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--side", mode, str(side)], cwd=side,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{mode} on {side} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--side", nargs=2, metavar=("MODE", "ROOT"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.side:
        mode, root = a.side[0], Path(a.side[1])
        run = side_check if mode == "check" else side_times
        print(json.dumps(run(root)))
        return 0
    if a.other is None:
        ap.error("OTHER, another checkout's root, is required")
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    sides = {"other": a.other.resolve(), "this": HERE}
    rows = []
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        builds = {}
        for name, root in sides.items():
            d = Path(tmp) / name
            d.mkdir()
            builds[name] = build_report(csrc_of(root), d)
            rows.append({"side": name, "root": str(root),
                         "build": builds[name]})
            print(json.dumps(rows[-1]), flush=True)
    same = sass_compared(builds["other"]["flash_attention.cu"]["sass"],
                         builds["this"]["flash_attention.cu"]["sass"])
    rows.append({"forward_sass_equal": same, "all": all(same.values())})
    print(json.dumps(rows[-1]), flush=True)
    errs = {name: _in_side("check", root) for name, root in sides.items()}
    turns = {name: [] for name in sides}
    order = list(sides) + list(sides)[::-1]
    for _ in range(a.rounds):
        for name in order:
            turns[name].append(_in_side("times", sides[name]))
    for shape in FORWARD_SHAPES + BACKWARD_SHAPES:
        for name in sides:
            row = {"shape": dict(zip(("name", "B", "Hq", "Hkv", "D", "S",
                                      "causal"), shape)),
                   "side": name, "err": errs[name][shape[0]], "card": smi}
            for k in turns[name][0][shape[0]]:
                vals = [t[shape[0]][k] for t in turns[name]
                        if t[shape[0]][k] is not None]
                row[f"{k}_ms"] = statistics.median(vals) if vals else None
            rows.append(row)
            print(json.dumps(row), flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
