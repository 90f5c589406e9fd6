"""The JAX package's sharded step on a 2x2x2 (pod, data, model) host
mesh, for the port's tensor-parallel tests to hold their ranks against.

Run as ``python torch_tp_jax_check.py IN.npz OUT.npz`` (it forces 8 host
devices before importing jax).  ``IN.npz`` holds, for each hidden width
``h`` in ``hids``, a transport case -- ``u{h}/<leaf>`` [P, D, *leaf],
``v{h}/<leaf>`` and ``delta{h}/<leaf>`` [P, *leaf], ``rho``, ``mu`` --
of the parity toy's tree.  For each width it writes:

  * ``vote{h}`` -- ``votes.fused_sign_vote_update`` on the mesh's
    sharded flat layout (``ModelSharding(2, "model", COMPUTE_SPECS)``),
    the global multi-bucket [P, n_pad] buffer, with ``n_pad{h}`` and
    ``shards{h}``;
  * ``xs{h}``, ``ys{h}``, ``w0{h}/<leaf>`` -- the toy problem
    (``parity_harness.make_problem(2, 2, hid=h)``);
  * ``fused{h}/<leaf>`` and ``ag_packed{h}/<leaf>`` -- the final edge
    models of ``parity_harness.run_hier``'s DC trajectory on the mesh,
    fused/flat and ag_packed/tree.
"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import parity_harness as H  # noqa: E402
from repro.core import flatbuf, votes  # noqa: E402
from repro.core.topology import Topology  # noqa: E402

P_, D_, M_ = 2, 2, 2


def tree(inp, prefix):
    return {k.split("/", 1)[1]: jnp.asarray(inp[k]) for k in inp.files
            if k.startswith(prefix + "/")}


def main(src: str, dst: str) -> None:
    inp = np.load(src)
    mesh = Mesh(np.array(jax.devices()).reshape(P_, D_, M_),
                ("pod", "data", "model"))
    topo = Topology(mesh=mesh, pod_axis="pod")
    out = {}
    for hid in inp["hids"]:
        u, v, delta = (tree(inp, f"{n}{hid}") for n in ("u", "v", "delta"))
        layout = flatbuf.make_layout(v, batch_dims=1,
                                     sharding=flatbuf.ModelSharding(
                                         M_, "model", H.COMPUTE_SPECS))
        v_buf = flatbuf.flatten_tree(layout, v, batch_dims=1)
        d_buf = flatbuf.flatten_tree(layout, delta, batch_dims=1)
        mask = jnp.ones((P_, D_), bool)
        mu = float(inp["mu"])
        new = votes.fused_sign_vote_update(
            topo, layout, u, d_buf, float(inp["rho"]), mask, v_buf,
            jnp.float32(mu), mu_static=mu)
        out[f"vote{hid}"] = np.asarray(new)
        out[f"n_pad{hid}"] = layout.n_pad
        out[f"shards{hid}"] = layout.shards
        prob = H.make_problem(P_, D_, hid=int(hid))
        out[f"xs{hid}"] = np.asarray(prob["xs"])
        out[f"ys{hid}"] = np.asarray(prob["ys"])
        for k, a in prob["w0"].items():
            out[f"w0{hid}/{k}"] = np.asarray(a)
        for transport, lay in (("fused", "flat"), ("ag_packed", "tree")):
            params, _ = H.run_hier(topo, prob, "dc_hier_signsgd", transport,
                                   lay)
            for k, a in params.items():
                out[f"{transport}{hid}/{k}"] = np.asarray(a)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
