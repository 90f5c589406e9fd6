#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. build the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc);
  2. hold each kernel bitwise against its plain PyTorch version on the
     card -- at the main path's shape [4, 5, 53248] and at [4, 5, 2^22],
     u in f32 and bf16, the DC correction on and off, voter masks none /
     bool (all voters, as the main path passes it, and with voters
     dropped and one pod's quorum empty) / integer weights with one
     pod's quorum empty, the update and the vote-only forms -- and time
     both with CUDA events (median over
     repeats, the L2 cache flushed before each launch), plus each
     kernel's own device time from ``torch.profiler``;
  3. train the paper's task (MLP 784-64-10, Q=4 edges x D=5 devices,
     Dirichlet(0.1), B=400, T_E=15, mu=5e-3, rho=0.2, 2 rounds = 30 steps)
     with ``dc_hier_signsgd`` on the fused transport and the flat state,
     counting kernel launches; then rerun the same steps on the pure
     PyTorch ``ag_packed``/``tree`` path and require bitwise equal edge
     models.

It prints the card's name and power limit first, one JSON line per
kernel case, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet, at 700 W
CUDA_CORE_OPS_PER_S = 67e12      # same sheet: f32 outside the tensor cores
MAIN_SHAPE = (4, 5, 53248)       # the MLP's flat buffer: 13 tiles of 4096
LARGE_SHAPE = (4, 5, 1 << 22)
RHO, MU = 0.2, 5e-3
SOURCES = {
    "sign_pack": ("src/repro_torch/csrc/sign_pack.cu",
                  "src/repro/kernels/sign_pack.py:48"),
    "vote_update": ("src/repro_torch/csrc/vote_update.cu",
                    "src/repro/kernels/vote_update.py:60"),
}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Timer:
    """Median milliseconds of a call, by CUDA events, with the L2 cache
    flushed before every timed launch (the 50 MB L2 would otherwise hold
    the whole main-path working set).  That is the time a caller waits,
    the wrapper's host work included; :meth:`device_ms` is the kernel's
    own execution time, from ``torch.profiler``."""

    def __init__(self, torch, warmup: int = 3, reps: int = 25):
        self.torch, self.warmup, self.reps = torch, warmup, reps
        self.scratch = torch.empty(64 << 20, dtype=torch.uint8,
                                   device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.reps):
            self.scratch.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ms(self, fn, kernel: str) -> float | None:
        """Mean device time of the launches whose name holds ``kernel``
        over ``reps`` calls (L2 flushed before each); None when the
        profiler sees no such launch."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.launch.profile_step import device_us, on_device
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(self.reps):
                self.scratch.zero_()
                fn()
            self.torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if on_device(e) and kernel in e.key]
        calls = sum(e.count for e in evs)
        if not calls:
            return None
        return sum(map(device_us, evs)) / calls / 1e3


def sign_pack_bytes(shape, elt: int, with_delta: bool) -> int:
    p, d, n = shape
    delta_bytes = p * n * elt if with_delta else 0
    return p * d * n * elt + delta_bytes + p * d * n // 8


def vote_update_bytes(shape, update: bool, weights_bytes: int) -> int:
    p, d, n = shape
    out = 2 * p * n * 4 if update else p * n
    return p * d * n // 8 + out + weights_bytes


def sign_pack_ops(shape, with_delta: bool) -> int:
    """Per coordinate: the compare, plus the multiply and add of rho*delta."""
    p, d, n = shape
    return p * d * n * (3 if with_delta else 1)


def vote_update_ops(shape, update: bool) -> int:
    """Per coordinate: a bit test and a weighted add per voter, the vote's
    compare and select, and the multiply and subtract of the update."""
    p, d, n = shape
    return p * n * (2 * d + 2 + (2 if update else 0))


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the CUDA cores' rate, and which."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / CUDA_CORE_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def phase_kernels(torch, timer):
    """Kernels vs plain versions, bitwise; returns the main-path rows."""
    from repro_torch.core import signs
    from repro_torch.kernels import ref
    from repro_torch.kernels.sign_pack import sign_pack
    from repro_torch.kernels.vote_update import vote_update

    gen = torch.Generator(device="cuda").manual_seed(0)
    main_rows = {}
    for shape in (MAIN_SHAPE, LARGE_SHAPE):
        p, d, n = shape
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            delta = torch.randn((p, n), generator=gen, device="cuda").to(dtype)
            # signed zeros, NaN, subnormals, and coordinates where
            # u + rho*delta is exactly 0 in separate f32 rounding (an FMA
            # would not be)
            u[0, 0, :64] = 0.0
            u[0, 0, 64:128] = -0.0
            u[0, 1, :32] = float("nan")
            u[0, 2, :32] = -1e-40           # subnormal in f32: counts as 0
            u[1, :, :4096] = (-(ref.f32(RHO) * delta[1, :4096].float())
                              ).to(dtype)
            for with_delta in (False, True):
                dl = delta if with_delta else None
                got = sign_pack(u, dl, RHO)
                want = ref.sign_pack_ref(u, dl, RHO)
                torch.cuda.synchronize()
                mism = int((got != want).sum())
                err = float((signs.unpack_bits(got)
                             - signs.unpack_bits(want)).abs().max())
                row = {"kernel": "sign_pack", "shape": list(shape),
                       "dtype": str(dtype).split(".")[-1],
                       "delta": with_delta, "mismatched_words": mism,
                       "max_abs_err": err,
                       "kernel_ms": timer(lambda: sign_pack(u, dl, RHO)),
                       "kernel_device_ms": timer.device_ms(
                           lambda: sign_pack(u, dl, RHO), "sign_pack_kernel"),
                       "plain_ms": timer(
                           lambda: ref.sign_pack_ref(u, dl, RHO))}
                row["bound_ms"], row["bound_by"] = bound(
                    sign_pack_bytes(shape, u.element_size(), with_delta),
                    sign_pack_ops(shape, with_delta))
                emit(row)
                require(mism == 0, f"sign_pack disagrees with its plain "
                        f"version: {row}")
                if (shape, dtype, with_delta) == (MAIN_SHAPE, torch.float32,
                                                  True):
                    main_rows["sign_pack"] = row
        words = ref.sign_pack_ref(
            torch.randn(shape, generator=gen, device="cuda"), None, 0.0)
        masks = {
            "none": None,
            "bool": torch.ones((p, d), dtype=torch.bool, device="cuda"),
            "bool_empty_quorum": torch.tensor(
                [[1, 0, 1, 1, 1], [0] * d, [0, 1, 0, 0, 1], [1, 1, 0, 1, 0]],
                dtype=torch.bool, device="cuda")[:p, :d],
            "int_empty_quorum": torch.tensor(
                [[3, 0, 1, 2, 5], [0] * d, [1, 1, 1, 1, 0], [7, 1, 1, 1, 1]],
                dtype=torch.int32, device="cuda")[:p, :d],
        }
        for mname, mask in masks.items():
            v0 = torch.randn((p, n), generator=gen, device="cuda")
            for update in (True, False):
                if update:
                    got = vote_update(words, v0.clone(), MU, mask)
                    want = ref.vote_update_ref(words, v0, MU, mask)
                    torch.cuda.synchronize()
                    mism = int((got.view(torch.int32)
                                != want.view(torch.int32)).sum())
                    err = float((got - want).abs().max())
                    untouched = torch.equal(got[1], v0[1])
                    v = v0.clone()
                    kfn = lambda: vote_update(words, v, MU, mask)
                    pfn = lambda: ref.vote_update_ref(words, v0, MU, mask)
                else:
                    got = vote_update(words, None, 0.0, mask)
                    want = ref.vote_update_ref(words, None, 0.0, mask)
                    torch.cuda.synchronize()
                    mism = int((got != want).sum())
                    err = float((got.float() - want.float()).abs().max())
                    untouched = not bool(got[1].any())
                    kfn = lambda: vote_update(words, None, 0.0, mask)
                    pfn = lambda: ref.vote_update_ref(words, None, 0.0, mask)
                wbytes = 0 if mask is None else mask.numel() * \
                    mask.element_size()
                row = {"kernel": "vote_update", "shape": list(shape),
                       "mask": mname, "form": "update" if update else "vote",
                       "mismatched": mism, "max_abs_err": err,
                       "kernel_ms": timer(kfn),
                       "kernel_device_ms": timer.device_ms(
                           kfn, "vote_update_kernel"),
                       "plain_ms": timer(pfn)}
                row["bound_ms"], row["bound_by"] = bound(
                    vote_update_bytes(shape, update, wbytes),
                    vote_update_ops(shape, update))
                emit(row)
                require(mism == 0, f"vote_update disagrees with its plain "
                        f"version: {row}")
                if mname.endswith("empty_quorum"):
                    require(untouched, f"pod 1's empty quorum moved its "
                            f"model or voted: {row}")
                if (shape, mname, update) == (MAIN_SHAPE, "bool", True):
                    main_rows["vote_update"] = row
    return main_rows


def phase_slice(torch):
    """The paper task on the fused/flat path, then on ag_packed/tree."""
    from repro_torch.kernels.sign_pack import sign_pack
    from repro_torch.kernels.vote_update import vote_update
    from repro_torch.launch.train import FedBenchCfg, run_paper_task

    cfg = FedBenchCfg(method="dc_hier_signsgd", rounds=2, t_e=15, batch=400,
                      mu=MU, rho=RHO, n_train=20000, q_edges=4,
                      devices_per_edge=5, transport="fused",
                      state_layout="flat")
    steps = cfg.rounds * cfg.t_e
    sign_pack.launches = 0
    vote_update.launches = 0
    fused = run_paper_task(cfg, device="cuda")
    launches = {"sign_pack": sign_pack.launches,
                "vote_update": vote_update.launches}
    print(f"[slice] fused/flat: loss {fused['loss']} acc {fused['acc']} "
          f"ms/step {fused['ms_per_step']} launches {launches}", flush=True)
    for name, count in launches.items():
        require(count == steps, f"{name} launched {count} times in "
                f"{steps} steps (want one launch per step)")
    require(fused["loss"][-1] < fused["loss"][0],
            f"test loss did not fall: {fused['loss']}")
    plain = run_paper_task(dataclasses.replace(
        cfg, transport="ag_packed", state_layout="tree"), device="cuda")
    require(sign_pack.launches == steps and vote_update.launches == steps,
            "the ag_packed/tree run launched a kernel")
    for name, leaf in fused["params"].items():
        other = plain["params"][name]
        require(tuple(leaf.shape) == tuple(other.shape),
                f"{name}: shape {tuple(leaf.shape)} vs {tuple(other.shape)}")
        require(bool(torch.isfinite(leaf).all()), f"{name}: non-finite")
        diff = int((leaf.contiguous().view(torch.int32)
                    != other.contiguous().view(torch.int32)).sum())
        require(diff == 0, f"{name}: fused/flat and ag_packed/tree edge "
                f"models differ in {diff} coordinates")
    print("[slice] fused/flat == ag_packed/tree edge models, bitwise",
          flush=True)
    return fused, plain, launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    build.load()
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)

    from repro_torch.core.topology import resolve_device
    resolve_device("cuda")
    timer = Timer(torch)
    main_rows = phase_kernels(torch, timer)
    fused, plain, launches = phase_slice(torch)

    kernels = []
    for name in ("sign_pack", "vote_update"):
        row = main_rows[name]
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"], "device_ms": row["kernel_device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
    print(f"[slice] ms/step fused/flat {fused['ms_per_step']} "
          f"ag_packed/tree {plain['ms_per_step']}", flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
