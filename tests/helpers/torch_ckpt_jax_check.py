"""The JAX package's checkpoints on its host meshes, for the port's mesh
checkpoint tests (``tests/test_torch_ckpt_mesh.py``).

Run as ``python torch_ckpt_jax_check.py DIR`` (it forces 8 host devices
before importing jax), beside the port's ranks, which share ``DIR``:

  1. JAX trains the parity toy (hidden 65, DC with error feedback) 2
     steps on its 2 x 2 x 2 (pod, data, model) mesh, flat and tree, and
     saves each state to ``DIR/jax/toy_<layout>`` with its global numpy
     state beside it (``toy_<layout>.pkl``); then ``DIR/jax.done``.
  2. Once the ranks wrote ``DIR/port.done``, for each case of
     ``DIR/cases.pkl`` (name -> (kind, layout, grid)) JAX builds the
     same config's state on the same mesh (its own ``init_fn`` under
     jit: its layouts, its shardings), fills it with the ranks' global
     state (``DIR/port/<name>.pkl``), saves it to ``DIR/jaxsave/<name>``
     and restores the ranks' checkpoint (``DIR/port/<name>``) into its
     sharded state (``store.restore``), writing the restored global state
     to ``DIR/jaxsave/<name>.pkl``; then ``DIR/jaxsave.done``.
"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import functools  # noqa: E402
import pathlib  # noqa: E402
import pickle  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import parity_harness as H  # noqa: E402
from repro import configs  # noqa: E402
from repro.checkpoint import store  # noqa: E402
from repro.core import flatbuf, hier  # noqa: E402
from repro.core.topology import Topology  # noqa: E402
from repro.models import build  # noqa: E402

GRIDS = {"2x2x2": (2, 2, 2), "2x4x1": (2, 4, 1)}
HID, STEPS, T_E = 65, 2, 2
WAIT_S = 120.0


def topology(grid: str) -> Topology:
    shape = GRIDS[grid]
    mesh = Mesh(np.array(jax.devices()).reshape(shape),
                ("pod", "data", "model"))
    return Topology(mesh=mesh, pod_axis="pod")


def algo(kind: str, layout: str) -> hier.AlgoConfig:
    transport = "fused" if layout == "flat" else "ag_packed"
    if kind == "toy":
        return H._algo("dc_hier_signsgd", transport, layout, t_e=T_E,
                       rho=0.2, error_feedback=True)
    return hier.AlgoConfig(method="dc_hier_signsgd", t_e=T_E,
                           transport=transport, state_layout=layout,
                           compute_dtype=jnp.float32)


def init_state(kind: str, layout: str, grid: str, compiled: bool = True):
    """The config's state on the grid's mesh, from JAX's own init: under
    jit (its shardings), or with ``compiled=False`` its structure and
    layouts alone (``jax.eval_shape``: no compile, no placement)."""
    topo = topology(grid)
    prob = None
    if kind == "toy":
        init_fn, step = hier.make_hier_step(topo, algo(kind, layout),
                                            H.make_bundle())
        if compiled:             # a seeded regression (numpy: no eager
            rng = np.random.default_rng(0)      # op to compile)
            lead = (STEPS, topo.pods, topo.devices_per_pod, 8)
            prob = {"xs": rng.standard_normal(lead + (H.DIN,), np.float32),
                    "ys": rng.standard_normal(lead + (H.DOUT,), np.float32)}
            params = {n: 0.3 * rng.standard_normal(s, np.float32)
                      for n, s in (("w", (H.DIN, HID)), ("b", (H.DOUT,)),
                                   ("w2", (HID, H.DOUT)))}
        else:
            params = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in (
                ("w", (H.DIN, HID)), ("b", (H.DOUT,)), ("w2", (HID, H.DOUT)))}
    else:
        built = build.build_model(configs.get_smoke("gemma3_1b"), topo)
        init_fn, step = hier.make_hier_step(topo, algo(kind, layout),
                                            built.bundle)
        params = (jax.jit(built.init_params) if compiled else functools.partial(
            jax.eval_shape, built.init_params))(jax.random.PRNGKey(0))
    state = (jax.jit(init_fn) if compiled else functools.partial(
        jax.eval_shape, init_fn))(params, jax.random.PRNGKey(1))
    return topo, step, state, prob


def as_numpy(state) -> dict:
    """The global state's slots as numpy (a flat slot its buffer), no
    generator."""
    out = {}
    for name in state._fields:
        if name == "rng":
            continue
        x = getattr(state, name)
        if isinstance(x, flatbuf.FlatState):
            x = x.buf
        out[name] = jax.tree.map(np.asarray, x)
    return out


def filled(state, glob: dict, seed: int):
    """``state``'s structure and layouts holding the ranks' global state
    (``glob``) and the key of the ranks' generator seed."""
    out = {}
    for name in state._fields:
        x = getattr(state, name)
        if name == "rng":
            out[name] = jax.random.PRNGKey(seed)
        elif name == "step":
            out[name] = jnp.asarray(glob["step"], jnp.int32)
        elif isinstance(x, flatbuf.FlatState):
            out[name] = x.replace(buf=jnp.asarray(glob[name]).astype(
                x.buf.dtype))
        elif x is None:
            out[name] = None
        else:
            out[name] = jax.tree.map(
                lambda a, g: jnp.asarray(g).astype(a.dtype), x, glob[name])
    return type(state)(**out)


def wait_for(path: pathlib.Path) -> None:
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > WAIT_S:
            raise TimeoutError(f"{path} did not appear in {WAIT_S} s")
        time.sleep(0.1)


def main(root: str) -> None:
    d = pathlib.Path(root)
    (d / "jax").mkdir(exist_ok=True)
    likes = {}                # the toy's sharded states, as restore likes
    for layout in ("flat", "tree"):
        _, step, state, prob = init_state("toy", layout, "2x2x2")
        jstep = jax.jit(step)
        ew = jnp.full((2,), 0.5)
        dw = jnp.full((2, 2), 0.5)
        mask = jnp.ones((2, 2))
        for s in range(STEPS):
            batch = {"train": {"x": prob["xs"][s], "y": prob["ys"][s]},
                     "anchor": {"x": prob["xs"][0], "y": prob["ys"][0]}}
            state, _ = jstep(state, batch, ew, dw, mask)
        store.save(d / "jax" / f"toy_{layout}", STEPS, state)
        with open(d / "jax" / f"toy_{layout}.pkl", "wb") as f:
            pickle.dump(as_numpy(state), f)
        likes[("toy", layout, "2x2x2")] = state
    (d / "jax.done").touch()
    wait_for(d / "port.done")
    with open(d / "cases.pkl", "rb") as f:
        cases = pickle.load(f)
    (d / "jaxsave").mkdir(exist_ok=True)
    for name, case in cases.items():
        # the model-sharded cases restore into JAX's sharded state; the
        # others into its structure, placed on one device
        like = likes.get(tuple(case))
        if like is None:
            like = init_state(*case, compiled=case[2] == "2x2x2")[2]
        with open(d / "port" / f"{name}.pkl", "rb") as f:
            port = pickle.load(f)
        step = int(port["state"]["step"])
        store.save(d / "jaxsave" / name, step,
                   filled(like, port["state"], port["seed"]))
        restored = store.restore(d / "port" / name, step, like)
        with open(d / "jaxsave" / f"{name}.pkl", "wb") as f:
            pickle.dump({"restored": as_numpy(restored),
                         "rng": np.asarray(restored.rng)}, f)
    (d / "jaxsave.done").touch()


if __name__ == "__main__":
    main(sys.argv[1])
