"""Multi-pod dry run of the port: trace every (arch x shape x mesh) cell
on fake tensors, one rank of the production grid, nothing allocated.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell for
512 forced host devices and reads XLA's memory and cost analyses.  Here
there is no compiler to ask: each cell's step runs once through the
port's own code on *fake* tensors (``torch._subclasses.FakeTensorMode``:
a shape, a dtype and a device, no storage), as rank ``--rank`` of the
production grid laid over a fake default group of 256 or 512 ranks in
this process (``launch.mesh.dry_topology``).  Every collective of the
rank's step runs ``core.comm``'s normal path on that group -- which
moves nothing -- and is counted in ``comm.traffic`` as a real run's is;
every kernel wrapper takes its fake path (``kernels.build.is_fake``):
the output's shape and dtype, no launch, a count in
``build.fake_calls``.  For each cell the dry run

  1. lays the production grid (``(16, 16)`` single-pod, ``(2, 16, 16)``
     multi-pod) over the fake group, at the rank asked for (default 0);
  2. lowers the cell's step: the rank's abstract state, batch and
     membership arrays (``launch.specs``) and the function --
       train_4k    -> ``hier.make_hier_step``'s train step, twice: a step
                      inside a round (``sync="never"``: state step 1) and
                      a step at a round boundary (``sync="always"``: state
                      step 0, the prologue, the cloud mean and the
                      anchors) -- a global round costs (T_E-1) x never +
                      1 x always;
       prefill_32k -> ``built.prefill`` (max_len = seq_len + n_patches);
       decode_*    -> ``built.decode_step``, one token against a full
                      cache (long_500k: one request, the cache split by
                      length over the data ranks);
  3. traces it (:func:`analyze`), measuring the rank's memory (every
     storage the call makes, live until its last tensor dies), its FLOPs
     and bytes, its collectives' bytes by op and by group, and the
     kernels it would launch;
  4. writes a JSON record a cell under ``reports/dryrun_torch/`` (``.err``
     with the traceback on failure).

A phase's record, beside JAX's keys (``analyze``'s ``dryrun.py:108-140``):

  =====================================  ================================
  JAX                                    port
  =====================================  ================================
  ``compile_s``                          ``trace_s``: host seconds of the
                                         fake trace
  ``memory.argument_size_in_bytes``      ``memory.argument_bytes``: the
                                         rank's live inputs at the call
  ``memory.output_size_in_bytes``        ``memory.output_bytes``
  ``memory.temp_size_in_bytes``          ``memory.temp_bytes`` =
                                         ``peak_bytes`` (the most bytes
                                         live at once in the call,
                                         inputs included) - arguments
  ``memory.alias_size_in_bytes``         ``memory.alias_bytes``: outputs
                                         sharing an input's storage (the
                                         fused flat update's master)
  ``memory.generated_code_size_in_...``  ``generated_code_bytes``: null,
                                         there is no compiled program
  ``xla_cost.flops``                     ``cost.flops``
                                         (``torch.utils.flop_counter``:
                                         matmuls, convolutions, SDPA --
                                         no elementwise op)
  ``xla_cost["bytes accessed"]``         ``cost.bytes_accessed``: every
                                         ATen op's tensor inputs and
                                         outputs (views, metadata ops,
                                         allocations that write nothing
                                         and copies between devices
                                         excluded), as XLA sums an
                                         HLO's operands and results,
                                         plus each kernel's reads and
                                         writes on its fake path
  ``hlo`` (each axis's bytes)            ``comm``: ``comm.traffic`` by op
                                         and ``comm.group_bytes()`` by
                                         group, sent and received
  (none)                                 ``launches``: each kernel's
                                         calls in the phase
  =====================================  ================================

What it counts differently: the memory is what this one rank would
allocate op by op in eager PyTorch (the caching allocator's rounding to
512 bytes and its cached free blocks not counted), not a compiled
program's buffer assignment; ``temp_bytes`` is therefore the eager
peak's excess over the inputs.  A fake kernel call allocates what the
CUDA route allocates (its output), not the plain version's temporaries,
so a CPU dry run and a CUDA dry run give the same numbers.  Collective
bytes are ``core.comm``'s count -- a rank's tensor sent and its peers'
received -- not a ring's wire bytes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch gemma3_1b --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch all --shape all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import pathlib
import time
import traceback
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.core import clients as vclients
from repro_torch.core import comm, flatbuf, hier, schedule
from repro_torch.core.topology import resolve_device
from repro_torch.data import synthetic
from repro_torch.kernels import build as kbuild
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as S
from repro_torch.models import build
from repro_torch.models.config import SHAPES

REPORT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "reports"
              / "dryrun_torch")
MESH_TAGS = {False: "single", True: "multi"}


class _Meter(TorchDispatchMode):
    """The traced call's bytes and FLOPs, op by op: each storage it makes,
    live from the op that makes it until its last tensor dies (a weak
    reference's callback) -- the bytes live now and at the most --, every
    op's tensor bytes in and out (but ``_UNCOUNTED``'s), and the FLOPs of
    the ops
    ``torch.utils.flop_counter`` counts (``FlopCounterMode``'s registry:
    matmuls, convolutions, attention)."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry
        super().__init__()
        self.live = self.peak = self.accessed = self.flops = 0
        self.sizes: dict = {}          # storage -> (weakref, nbytes)
        self.registry = flop_registry

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        got = self.sizes.get(key)
        if got is not None:
            if got[1] == n:
                return
            self.live -= got[1]        # resized in place
        self.sizes[key] = (weakref.ref(st, functools.partial(
            self._gone, key)), n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _gone(self, key, _ref) -> None:
        got = self.sizes.pop(key, None)
        if got is not None:
            self.live -= got[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_tensors((out,)))
        if not (func.is_view or func._overloadpacket in _UNCOUNTED
                or _transfer(func, args, outs)):
            self.accessed += sum(map(_nbytes, _tensors(args))) + sum(
                map(_nbytes, _tensors(kwargs.values()))) + sum(
                map(_nbytes, outs))
            count = self.registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
        for t in outs:
            self.track(t)
        return out


_aten = torch.ops.aten
_UNCOUNTED = {   # ops that read and write no tensor's data: metadata,
    _aten.detach, _aten.alias, torch.ops.prim.device, _aten.lift_fresh,
    _aten.empty, _aten.empty_like, _aten.empty_strided,   # allocations
    _aten.new_empty, _aten.new_empty_strided}


_COPIES = {torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default}


def _transfer(func, args, outs) -> bool:
    """Whether the op copies a tensor from one device to another (the
    host's numbers onto the card): no op of a CPU dry run, so not counted
    in the bytes accessed of either."""
    return func in _COPIES and any(
        t.device != outs[0].device for t in _tensors(args))


def _tensors(xs):
    """The tensors of ``xs`` and of the lists and tuples in it."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storages(tree) -> dict:
    """``{storage key: nbytes}`` of every tensor in ``tree`` (a storage
    counted once however many tensors view it)."""
    out = {}
    for t in _tensors([_plain(tree)]):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _plain(tree):
    """``tree`` as nested lists of its tensors: a ``TrainState``'s slots
    opened, a ``FlatState`` its buffer, anything else (a generator, a
    number) dropped."""
    if isinstance(tree, hier.TrainState):
        return [_plain(v) for v in tree]
    if isinstance(tree, flatbuf.FlatState):
        return tree.buf
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    if isinstance(tree, dict):
        return [_plain(v) for v in tree.values()]
    return tree if isinstance(tree, torch.Tensor) else None


@dataclasses.dataclass
class Lowered:
    """A cell's phase ready to trace: ``fn(*args)`` on fake tensors made
    in ``mode``."""
    fn: Callable
    args: tuple
    mode: Any


def fake_mode():
    """The fake-tensor mode a cell's tensors are made and traced in."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def lower_train(built, topo, algo, shape, sync, mode=None) -> Lowered:
    """The train step at a round boundary (``sync="always"``: state step
    0) or inside a round (``"never"``: step 1).  Under the overlapped
    cloud only the prologue changes, so ``"never"`` traces the sync
    program, as the JAX dry run lowers it."""
    if sync == "never" and algo.is_overlap:
        algo = dataclasses.replace(algo, cloud_overlap="sync")
    mode = fake_mode() if mode is None else mode
    with mode:
        init_fn, step = hier.make_hier_step(topo, algo, built.bundle)
    state, _ = S.train_state_abstract(built, topo, algo, mode, init_fn)
    state = state._replace(step=0 if sync == "always" else 1)
    batch, _ = S.train_batch_abstract(built.cfg, shape, topo, mode)
    weights, _ = S.weights_abstract(topo, algo.clients, mode)
    return Lowered(step, (state, batch) + weights, mode)


def chaos_report(topo, algo, cfg, seed, steps):
    """Compile a seeded chaos schedule against this cell's membership
    and check every emitted array against the step's abstract weight
    specs -- the whole schedule replays against ONE step of fixed shapes
    (churn changes no shape)."""
    from repro_torch.runtime import chaos, elastic
    if cfg.param_mode == "fsdp":
        return {"skipped": True,
                "reason": "client-granular membership requires the "
                          "replicated regime (FSDP lifts the voter axis "
                          "away)"}
    member = elastic.Membership(topo.pods, topo.devices_per_pod,
                                clients=algo.clients)
    inj = chaos.FaultInjector.seeded(seed, steps, topo.pods,
                                     topo.devices_per_pod,
                                     algo.clients.count)
    arrays = chaos.compile_schedule(inj, member, steps)
    specs, _ = S.weights_abstract(topo, algo.clients)
    for arr in arrays:
        for got, want in zip(arr, specs):
            ok = (got.shape == tuple(want.shape)
                  and torch.from_numpy(got).dtype == want.dtype)
            assert ok, (
                f"membership array {got.shape}/{got.dtype} would not fit "
                f"a step traced for {tuple(want.shape)}/{want.dtype}")
    distinct = len({(a.edge_weights.tobytes(), a.dev_weights.tobytes(),
                     a.mask.tobytes()) for a in arrays})
    return {"skipped": False, "seed": seed, "steps": steps,
            "events": len(inj.events), "distinct_memberships": distinct,
            "recompilations": 0}


def lower_prefill(built, topo, shape, mode=None) -> Lowered:
    mode = fake_mode() if mode is None else mode
    params = S.serve_params_abstract(built, mode)
    batch, _ = S.prefill_batch_abstract(built.cfg, shape, topo, mode)
    # VLM prompts occupy n_patches extra cache slots
    max_len = shape.seq_len + built.cfg.n_patches
    fn = functools.partial(built.prefill, max_len=max_len)
    return Lowered(fn, (params, batch), mode)


def lower_decode(built, topo, shape, mode=None) -> Lowered:
    """One token against a full cache; one request (long_500k) is served
    replicated over the batch ranks with the cache's length split over
    the data ranks (``build.make_serve_fns(rows="replicated",
    len_axis="data")``)."""
    mode = fake_mode() if mode is None else mode
    params = S.serve_params_abstract(built, mode)
    (cache, tokens), _ = S.decode_args_abstract(built, shape, topo, mode)
    fn = built.decode_step
    if shape.global_batch == 1:
        _, fn = build.make_serve_fns(built.arch, topo, built.serve_layout,
                                     rows="replicated", len_axis="data")
    return Lowered(fn, (params, cache, tokens), mode)


def analyze(lowered: Lowered, label: str, verbose: bool = True) -> dict:
    """Trace ``lowered`` once: its memory, cost, collectives and kernel
    calls (the module docstring's table)."""
    comm.reset_traffic()
    kbuild.reset_fake_calls()
    meter = _Meter()
    args = _storages(lowered.args)
    for key, n in args.items():
        meter.sizes[key] = (None, n)
    meter.live = meter.peak = sum(args.values())
    t0 = time.perf_counter()
    with lowered.mode, meter:
        out = lowered.fn(*lowered.args)
    trace_s = time.perf_counter() - t0
    outs = _storages(out)
    arg_bytes = sum(args.values())
    mem = {"argument_bytes": arg_bytes,
           "output_bytes": sum(outs.values()),
           "temp_bytes": meter.peak - arg_bytes,
           "peak_bytes": meter.peak,
           "alias_bytes": sum(n for k, n in outs.items() if k in args),
           "generated_code_bytes": None}
    cost = {"flops": meter.flops,
            "bytes_accessed": meter.accessed
            + sum(kbuild.fake_bytes.values())}
    rec = {"label": label, "trace_s": round(trace_s, 1), "memory": mem,
           "cost": cost,
           "comm": {"ops": {op: dict(v) for op, v in comm.traffic.items()
                            if v["calls"]},
                    "groups": comm.group_bytes()},
           "launches": dict(kbuild.fake_calls)}
    if verbose:
        print(f"    [{label}] trace={trace_s:.1f}s")
        print(f"    memory: {mem}")
        print(f"    cost: flops={cost['flops']} "
              f"bytes={cost['bytes_accessed']}")
        print(f"    comm: {rec['comm']['groups']}")
        print(f"    launches: {rec['launches']}")
    return rec


def run_cell(arch_name, shape_name, multi_pod, method, transport,
             t_e, verbose=True, state_layout="tree",
             clients=None, chaos_seed=None, cloud_overlap="sync",
             device="cuda", rank=0):
    """One cell's record: JAX's skip rules and keys, then (when it
    applies) ``params``, the traced ``rank`` and ``device``, and a
    record a phase (and ``chaos`` with ``chaos_seed`` on a train
    cell)."""
    shape = SHAPES[shape_name]
    cfg = configs.get_config(arch_name)
    ok, why = configs.shape_applicable(cfg, shape)
    if (ok and shape.kind == "train" and cfg.param_mode == "fsdp"
            and method in hier.CLIENT_CORRECTION_METHODS):
        # scaffold/mtgc per-client state rides the explicit voter axis,
        # which the FSDP lift never materializes -- clean SKIP instead
        # of the make_hier_step ValueError
        ok, why = False, f"{method} requires the replicated regime"
    if (ok and shape.kind == "train" and cfg.param_mode == "fsdp"
            and clients is not None and clients.active):
        ok, why = False, "virtual clients require the replicated regime"
    if (ok and shape.kind == "train" and cfg.param_mode == "fsdp"
            and cloud_overlap == "overlap"):
        # the staged in-flight aggregate is a whole-model master
        # snapshot the FSDP lift never materializes -- clean SKIP, same
        # contract as the cells above
        ok, why = False, ("cloud_overlap='overlap' requires the "
                          "replicated regime")
    cell = {
        "arch": arch_name, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "method": method, "transport": transport,
        "cloud_overlap": cloud_overlap,
        "params": None, "skipped": not ok, "skip_reason": why,
    }
    if not ok:
        print(f"  SKIP {arch_name} x {shape_name}: {why}")
        return cell
    with mesh_mod.dry_topology(multi_pod=multi_pod, rank=rank,
                               device=device) as topo:
        built = build.build_model(cfg, topo)
        cell["params"] = build.param_count(built.abstract_params())
        cell["rank"] = rank
        cell["device"] = topo.device.type
        algo = hier.AlgoConfig(method=method, transport=transport, t_e=t_e,
                               state_layout=state_layout,
                               cloud_overlap=cloud_overlap,
                               clients=clients or vclients.ClientConfig())
        phases = {}
        if shape.kind == "train":
            for label, sync in (("local_step", "never"),
                                ("sync_step", "always")):
                phases[label] = analyze(lower_train(
                    built, topo, algo, shape, sync), label, verbose)
            if chaos_seed is not None:
                cell["chaos"] = chaos_report(topo, algo, cfg, chaos_seed,
                                             steps=4 * t_e)
                if verbose:
                    print(f"    chaos: {cell['chaos']}")
        elif shape.kind == "prefill":
            phases["prefill"] = analyze(lower_prefill(built, topo, shape),
                                        "prefill", verbose)
        else:
            phases["decode"] = analyze(lower_decode(built, topo, shape),
                                       "decode", verbose)
    cell["phases"] = phases
    return cell


H100_BYTES = 80e9           # an H100's device memory (80 GB HBM3)


def table(out_dir) -> str:
    """The markdown table of the records in ``out_dir``: a row a cell's
    phase, the 16x16 and 2x16x16 grids side by side -- the rank's peak
    GB and whether it fits an H100's 80 GB, its argument GB, TFLOP, the
    GB it sends and receives on the data, pod and model groups, the
    kernels' calls and the host's trace seconds -- then the skips."""
    cells: dict = {}
    skips = []
    for path in sorted(pathlib.Path(out_dir).glob("*.json")):
        cell = json.loads(path.read_text())
        if cell["skipped"]:
            skips.append(cell)
            continue
        for label, ph in cell["phases"].items():
            cells.setdefault((cell["arch"], cell["shape"], label),
                             {})[cell["mesh"]] = ph
    gb = lambda n: f"{n / 1e9:.2f}"                      # noqa: E731

    def both(phs, fn):
        return " / ".join(fn(phs[m]) if m in phs else "-"
                          for m in ("16x16", "2x16x16"))

    def group(name):
        return lambda ph: (f"{gb(ph['comm']['groups'][name]['sent'])}:"
                           f"{gb(ph['comm']['groups'][name]['received'])}")
    lines = ["| arch | shape | phase | peak GB a rank | fits 80 GB | "
             "arguments GB | TFLOP | data GB sent:received | pod GB | "
             "model GB | kernel calls | trace s (host) |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- "
             "| --- | --- |"]
    order = {a: i for i, a in enumerate(configs.ARCH_NAMES)}
    shapes = {s: i for i, s in enumerate(SHAPES)}
    for (arch, shape, label), phs in sorted(
            cells.items(), key=lambda kv: (order[kv[0][0]],
                                           shapes[kv[0][1]], kv[0][2])):
        lines.append(" | ".join([
            f"| {arch}", shape, label,
            both(phs, lambda ph: gb(ph["memory"]["peak_bytes"])),
            both(phs, lambda ph: "yes" if ph["memory"]["peak_bytes"]
                 <= H100_BYTES else "no"),
            both(phs, lambda ph: gb(ph["memory"]["argument_bytes"])),
            both(phs, lambda ph: f"{ph['cost']['flops'] / 1e12:.1f}"),
            both(phs, group("data")), both(phs, group("pod")),
            both(phs, group("model")),
            both(phs, lambda ph: str(sum(ph["launches"].values()))),
            both(phs, lambda ph: f"{ph['trace_s']:.1f}")]) + " |")
    grouped: dict = {}
    for c in skips:
        grouped.setdefault((c["shape"], c["skip_reason"]), set()).add(
            (c["arch"], c["mesh"]))
    for (shape, why), cells_ in sorted(grouped.items()):
        archs = sorted({a for a, _ in cells_}, key=order.get)
        lines.append(f"\nSkipped, {shape} ({len(cells_)} cells): "
                     f"{', '.join(archs)} -- {why}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="dry run of the port: every production cell traced "
                    "on fake tensors, one rank of a fake 256- or 512-rank "
                    "group")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--method", default="dc_hier_signsgd",
                    choices=hier.ALL_METHODS)
    ap.add_argument("--transport", default="ag_packed")
    ap.add_argument("--state_layout", default="tree",
                    choices=["tree", "flat"])
    ap.add_argument("--clients_per_device", type=int, default=1,
                    help="K virtual clients per data slice (per-device "
                         "batch must divide by K)")
    ap.add_argument("--client_mode", default="merged",
                    help="merged | stream (streamed in-step client loop, "
                         "one client's gradient live at a time)")
    ap.add_argument("--participation", default="full",
                    help="full | bernoulli | fixed (per-round sampled "
                         "quorum at --participation_rate)")
    ap.add_argument("--participation_rate", type=float, default=1.0)
    ap.add_argument("--alpha_client", type=float, default=None,
                    help="intra-edge Dirichlet concentration for the "
                         "synthetic stream scenario (None/inf = legacy "
                         "within-edge IID); validated up front only -- "
                         "tracing is data-independent")
    ap.add_argument("--edge_assign", default="fixed",
                    help="fixed | random | clustered client->edge "
                         "placement; clustered is rejected up front "
                         "unless the clients carve is active "
                         "(--clients_per_device>1 with --alpha_client)")
    ap.add_argument("--t_e", type=int, default=15)
    ap.add_argument("--cloud_overlap", default="sync",
                    help="sync | overlap (lagged cloud commit: the "
                         "always phase carries the staged agg_next "
                         "slot; the never phase is schedule-independent "
                         "and traced as sync; FSDP train cells report a "
                         "clean SKIP)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="attach a chaos-cell report to every train "
                         "cell: compile a seeded fault schedule "
                         "(runtime.chaos) against the cell's membership "
                         "and check the arrays fit the ONE traced step "
                         "(FSDP cells report a clean SKIP)")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (fake CUDA tensors; needs a card) or cpu "
                         "(fake CPU tensors): the numbers are the same")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the production grid whose block is "
                         "traced")
    ap.add_argument("--out", default=str(REPORT_DIR),
                    help="the directory of the cells' records")
    ap.add_argument("--table", action="store_true",
                    help="print the markdown table of the records in "
                         "--out and trace nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return

    if args.cloud_overlap not in schedule.CLOUD_OVERLAP_MODES:
        ap.error(f"--cloud_overlap must be one of "
                 f"{'/'.join(schedule.CLOUD_OVERLAP_MODES)}, got "
                 f"{args.cloud_overlap!r}")

    # scenario-axis validation up front: clustered assignment without an
    # active clients carve (or with a bad alpha_client) is a flag error,
    # not a deep stream-construction traceback
    try:
        synthetic.validate_scenario(synthetic.LMStreamCfg(
            vocab=2, seq_len=8,
            batch_per_device=max(args.clients_per_device, 1),
            pods=1, devices_per_pod=1,
            clients_per_device=args.clients_per_device,
            alpha_client=args.alpha_client, edge_assign=args.edge_assign))
    except ValueError as e:
        ap.error(str(e))

    archs = configs.ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    # surface the carve constraint as a clean CLI error for every
    # requested train cell, instead of a trace-time traceback
    if args.clients_per_device > 1:
        for multi in meshes:
            grid, _ = mesh_mod.make_production_mesh(multi_pod=multi)
            pd = math.prod(grid[:-1])
            for shape_name in shapes:
                shape = SHAPES[shape_name]
                if shape.kind != "train":
                    continue
                try:
                    vclients.validate_batch_carve(
                        shape.global_batch // pd, args.clients_per_device,
                        flag="clients_per_device")
                except ValueError as e:
                    ap.error(f"{shape_name} on the "
                             f"{'multi' if multi else 'single'}-pod mesh: "
                             f"{e}")
    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    world = min(math.prod(mesh_mod.make_production_mesh(multi_pod=m)[0])
                for m in meshes)
    if not 0 <= args.rank < world:
        ap.error(f"--rank {args.rank} is not a rank of every grid asked "
                 f"for (0 to {world - 1})")

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh_tag = MESH_TAGS[multi]
                out = out_dir / f"{args.tag}.{arch}.{shape}.{mesh_tag}.json"
                print(f"== {arch} x {shape} x {mesh_tag} "
                      f"[{args.method}/{args.transport}] ==", flush=True)
                t0 = time.time()
                try:
                    cc = vclients.ClientConfig(
                        count=args.clients_per_device,
                        participation=args.participation,
                        rate=args.participation_rate,
                        mode=args.client_mode)
                    cell = run_cell(arch, shape, multi, args.method,
                                    args.transport, args.t_e,
                                    verbose=not args.quiet,
                                    state_layout=args.state_layout,
                                    clients=cc, chaos_seed=args.chaos,
                                    cloud_overlap=args.cloud_overlap,
                                    device=args.device, rank=args.rank)
                    cell["wall_s"] = round(time.time() - t0, 1)
                    out.write_text(json.dumps(cell, indent=1))
                    print(f"   OK ({cell['wall_s']}s) -> {out.name}",
                          flush=True)
                except Exception:
                    n_fail += 1
                    err = traceback.format_exc()
                    out.with_suffix(".err").write_text(err)
                    print(f"   FAIL ({time.time()-t0:.0f}s):\n{err}",
                          flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
