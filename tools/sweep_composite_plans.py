"""B17's launch plan against its other column vectors and variants of its
kernel, on one NVIDIA GPU.

    python3 tools/sweep_composite_plans.py

On B17's three stacks as `chip_smoke.py` builds them -- the 24^3 golden
case's DIRECT plane (24, 256, 256), the compact 256x256x60 X+ stack (128,
256, 256) and the 512^3 DIRECT plane (170, 896, 1024) -- checks
`composite.composite_plan`'s layout, each forced vec
(`composite.composite_layout`) and, at the plan's vec, each variant of
csrc/composite.cu in VARIANTS (a change of a line or two, built apart
from the library) against the one-thread-a-texel design
(`composite.composite_perthread`, torch.equal), and times each, L2-warm and
L2-cold, with CUDA events behind a sleep kernel (chip_smoke.time_ms), in
turns: the per-texel design first and last, the plan and each variant
twice, the plan outermost.  Each share is of the bound of what the inputs
need (chip_smoke.b17_work).  Prints the registers ptxas gives each
instantiation of composite_kernel and the card's name and power limit
first.  Needs a CUDA device and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from fluidx12_tpu_torch.core.config import FluidConfig  # noqa: E402
from fluidx12_tpu_torch.ops.cuda import _build  # noqa: E402
from fluidx12_tpu_torch.ops.cuda import composite as C  # noqa: E402
from fluidx12_tpu_torch.render.screencomp import sample_plane_inputs  # noqa: E402
from fluidx12_tpu_torch.render.slicecomp import resampled_stack  # noqa: E402

REPS = 20

# The variants: (pattern, replacement) pairs applied to csrc/composite.cu,
# each of which must match exactly once.
VARIANTS = {
    # The same straight-line group, each quotient by `/`.
    "IEEE `/` for div_fast": [
        (r"(float div_fast\(float a, float b\) \{)[^}]*\}", r"\1 return a / b; }"),
        (r"(bool div_fast_exact\(float w\) \{)[^}]*\}", r"\1 return true; }"),
    ],
    # Every slice's prod staged, whatever its densities.
    "prod staged whole": [
        (r"stage_prod\(g \+ 1, true\);", "stage_prod(g + 1, false);"),
    ],
    # Group g + 1's prod staged while group g's may still be in flight.
    "two prod groups in flight": [
        (r"stage_dens\(0\);\n  stage_prod\(0, false\);\n  stage_dens\(1\);",
         "stage_dens(0);\n  stage_dens(1);\n  stage_prod(0, false);"),
        (r"cp_async_wait_pending<1>\(\);\n    stage_prod\(g \+ 1, true\);",
         "cp_async_wait_pending<2>();\n    stage_prod(g + 1, true);\n"
         "    cp_async_wait_pending<2>();"),
    ],
}


def compile_composite(src: str, out: Path) -> dict:
    """Builds `src` (a composite.cu) into the shared library `out`;
    returns ptxas's registers for each composite_kernel<vec>."""
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                           "-o", str(out), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {cu.name}:\n{proc.stderr}")
    regs, kernel = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel and "composite_kernelILi" in kernel:
            regs[int(re.search(r"composite_kernelILi(\d+)E", kernel).group(1))] = int(m.group(1))
    return regs


def build_all(tmp: Path) -> dict:
    """{name: (fx_composite or None for the library's own, registers)} for
    the kernel as it stands and each variant, built side by side."""
    src = (_build.CSRC / "composite.cu").read_text()
    sources = {"the plan": src}
    for name, subs in VARIANTS.items():
        text = src
        for pattern, repl in subs:
            text, n = re.subn(pattern, repl, text, flags=re.S)
            if n != 1:
                raise RuntimeError(f"variant {name!r}: {pattern!r} matched {n} times")
        sources[name] = text
    outs = {name: tmp / f"variant{i}.so" for i, name in enumerate(sources)}
    with ThreadPoolExecutor(len(sources)) as pool:
        regs = dict(zip(sources, pool.map(compile_composite, sources.values(), outs.values())))
    built = {}
    for name, out in outs.items():
        fn = None
        if name != "the plan":
            fn = ctypes.CDLL(str(out)).fx_composite
            fn.argtypes, fn.restype = _build._SIGNATURES["fx_composite"], ctypes.c_int
        built[name] = (fn, regs[name])
        print(f"{name}: registers {regs[name]}")
    return built


def plane(grid, viewport=(800, 800), orbit=(0.0, 0.0)):
    _, (volf, h_rows, h_cols, valid, n_steps) = sample_plane_inputs(
        grid, torch.device("cuda", 0), viewport=viewport, orbit=orbit)
    return resampled_stack(volf, h_rows, h_cols, valid, True) + (n_steps,)


def stacks():
    yield "24^3 DIRECT plane", plane((24, 24, 24), viewport=(64, 64)), 0.8
    _, dens, prod, n_steps = CS.slab_face_stack(torch.device("cuda", 0))
    yield "256x256x60 X+ stack", (dens, prod, n_steps), 0.8
    del dens, prod, n_steps
    yield "512^3 DIRECT plane", plane(CS.GRID_512, orbit=CS.ORBIT_512), \
        FluidConfig(grid_size=CS.GRID_512).absorption


def launcher(plan, absorption, fn=None):
    """fx_composite under `plan`, from the library or the variant `fn`."""
    def run(dens, prod, n_steps):
        out = torch.empty((4,) + tuple(n_steps.shape), device=dens.device)
        if fn is None:
            err = C._launch(dens, prod, n_steps, out, absorption, False, plan)
        else:
            n_s, r1, r2 = dens.shape
            err = fn(dens.data_ptr(), prod.data_ptr(), n_steps.data_ptr(), out.data_ptr(),
                     float(absorption), 0, n_s, r1, r2, plan.vec, plan.cols,
                     _build.stream_ptr(dens))
        _build.check(err, "fx_composite")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_composite_plans: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        built = build_all(Path(tmp))
        l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
        for label, stack, absorption in stacks():
            n_s, r1, r2 = stack[0].shape
            plan = C.composite_plan(n_s, r1, r2)
            bound = CS.bound(*CS.b17_work(*stack))[0]
            sets = [tuple(t.clone() for t in stack)
                    for _ in range(max(2, math.ceil(4 * l2 / CS.nbytes(*stack))))]

            def timed(fn):
                turn = iter(range(1 << 30))
                return (CS.time_ms(lambda: fn(*stack), REPS),
                        CS.time_ms(lambda: fn(*sets[next(turn) % len(sets)]), REPS))

            def yard(d, p, n):
                return C.composite_perthread(d, p, n, absorption, False)

            ref = yard(*stack)
            print(f"== B17, {label} {tuple(stack[0].shape)}: plan {plan}; bound of what the "
                  f"inputs need {bound:.4f} ms")
            runs = {f"vec {plan.vec} (the plan)": launcher(plan, absorption)}
            for name, (fn, _) in built.items():
                if fn is not None:
                    runs[f"vec {plan.vec}, {name}"] = launcher(plan, absorption, fn)
            for vec in C.VEC_CHOICES:
                if vec != plan.vec and r2 % vec == 0:
                    runs[f"vec {vec}"] = launcher(C.composite_layout(n_s, r1, r2, vec),
                                                  absorption)
            for name, run in runs.items():
                same = torch.equal(run(*stack), ref)
                print(f"  {name}: {'equal to' if same else 'DIFFERS from'} the per-texel design")
                CS.check(same, f"B17 {name} on {label}")
            names = list(runs)
            order = ["per-texel design"] + names + names[::-1] + ["per-texel design"]
            runs["per-texel design"] = yard
            for name in order:
                warm, cold = timed(runs[name])
                print(f"  {name}: {warm:.4f} ms warm ({100 * bound / warm:.1f}% of the bound), "
                      f"{cold:.4f} ms L2-cold ({100 * bound / cold:.1f}%)")
            del stack, sets, ref, runs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
