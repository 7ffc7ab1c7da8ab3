"""One rank of a mesh session on the CPU (gloo), for tests/test_torch_explore.py
and tests/test_torch_checkpoint.py.  It imports torch and gpis_tpu_torch only.

    python tests/torch_session_rank.py MODE DIR RANK WORLD

reads DIR/inputs.npz, joins a gloo group through the file store DIR/store
(collectives time out after 60 s, so a hung one ends the rank) and writes
its results to DIR/out<RANK>.npz with whether jax or any gpis_tpu module
was imported.  MODE "explore": a mesh session's next_best_path from a
world seed and from the default seed, and is_done.  MODE "checkpoint": a
mesh session touched, saved (rank 0 writes DIR/sharded.npz) and restored
into a new session, queried before and after a replayed touch beside the
uninterrupted session, and the JAX package's sharded checkpoint
(inputs["jax_path"]) restored and queried.  MODE "experts": a committee
fitted on every rank, this rank's share of it (`shard_experts`) queried by
`predict_sharded`, and a mesh session's refusal of `start(experts=)`.
MODE "batched": `fit_batch(mesh=)` of ragged clouds, this rank's share
queried by `predict_batch`.

Started by `tests/torch_ranks.spawn_ranks`.
"""

import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import ExploreConfig, MeshConfig, ModelConfig


def _session(inp, world, explore=None):
    cfg = ModelConfig(kernel="rbf", lengthscale=float(inp["ls"]), noise_surface=1e-5,
                      n_external=32, touch_capacity=int(inp.get("touch_capacity", 0)), block=64,
                      dtype="float64")
    return ObjectModelSession(cfg, explore, MeshConfig(n_devices=world, block=64), device="cpu")


def explore(inp, out_dir, rank, world, out) -> None:
    max_charts, n_disc, threshold = inp["explore"]
    ecfg = ExploreConfig(max_charts=int(max_charts), n_disc_samples=int(n_disc),
                         variance_threshold=float(threshold))
    sess = _session(inp, world, ecfg).start(inp["pts"])
    for which, seed in (("seed", inp["seed_world"]), ("default", None)):
        res = sess.next_best_path(seed_world=seed)
        out[f"{which}_n_charts"] = np.array(len(res.charts))
        out[f"{which}_ids"] = np.array([[c.id, c.parent] for c in res.charts])
        out[f"{which}_charts"] = np.array([[*c.center, c.radius, c.variance]
                                           for c in res.charts])
        out[f"{which}_path"] = res.path
    out["done"] = np.array(sess.is_done(64))


def checkpoint(inp, out_dir, rank, world, out) -> None:
    q = inp["q"]
    sess = _session(inp, world).start(inp["pts"]).update(inp["touch"][:2])
    path = f"{out_dir}/sharded.npz"
    sess.save(path)
    restored = _session(inp, world).restore(path)
    out["n_touch"] = np.array(restored.model.n_touch)
    out["band"] = restored.model.w.numpy()
    out["saved_mean"], out["saved_var"] = sess.query(q)
    out["restored_mean"], out["restored_var"] = restored.query(q)
    sess.update(inp["touch"][2:])
    restored.update(inp["touch"][2:])
    out["replayed_mean"], out["replayed_var"] = restored.query(q)
    out["uninterrupted_mean"], out["uninterrupted_var"] = sess.query(q)
    jax_sess = _session(inp, world).restore(str(inp["jax_path"]))
    out["jax_mean"], out["jax_var"] = jax_sess.query(q)


def experts(inp, out_dir, rank, world, out) -> None:
    from gpis_tpu_torch.gp import experts as ex
    from gpis_tpu_torch.parallel.mesh import make_row_mesh

    mesh = make_row_mesh(world, device="cpu")
    m = ex.fit_experts("rbf", torch.as_tensor(inp["x"]), torch.as_tensor(inp["y"]),
                       torch.as_tensor(inp["noise"]), {"lengthscale": 1.0,
                                                       "signal_variance": 1.0},
                       n_experts=8, n_shared_tail=int(inp["shared"]))
    local = ex.shard_experts(m, mesh)
    out["n_local"] = np.array(local.n_experts)
    out["sharded_mean"], out["sharded_var"] = (
        t.numpy() for t in ex.predict_sharded(local, torch.as_tensor(inp["q"]), mesh))
    try:
        _session(inp, world).start(inp["pts"], experts=4)
    except ValueError as e:
        out["mesh_refusal"] = np.array(str(e))


def batched(inp, out_dir, rank, world, out) -> None:
    from gpis_tpu_torch.gp import batched as gpb
    from gpis_tpu_torch.parallel.mesh import make_row_mesh

    clouds = [inp[f"cloud{i}"] for i in range(int(inp["n_objects"]))]
    model = gpb.fit_batch("rbf", clouds, [inp[f"y{i}"] for i in range(len(clouds))],
                          [1e-3] * len(clouds), {"lengthscale": 0.8, "signal_variance": 1.0},
                          block=32, dtype=torch.float64, mesh=make_row_mesh(world, device="cpu"))
    out["mean"], out["var"] = (t.numpy() for t in gpb.predict_batch(model, inp["q"]))


def main(mode: str, out_dir: str, rank: int, world: int) -> None:
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        inp = dict(np.load(f"{out_dir}/inputs.npz"))
        out = {}
        {"explore": explore, "checkpoint": checkpoint, "experts": experts,
         "batched": batched}[mode](inp, out_dir, rank, world, out)
        jax_pkg = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                   or m == "gpis_tpu" or m.startswith("gpis_tpu.")]
        out["imported"] = np.array(" ".join(jax_pkg))
        np.savez(f"{out_dir}/out{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
