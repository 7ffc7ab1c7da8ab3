"""One rank of the port's sharded joint pipeline on the CPU (gloo), for
tests/test_torch_sharded_joint.py.  It imports torch and gpis_tpu_torch only.

    python tests/torch_sharded_joint_rank.py DIR RANK WORLD

reads DIR/inputs.npz, joins a gloo group through the file store DIR/store
(collectives time out after 60 s), runs the sharded joint functions on the
inputs (the band Gram, the fit and its predict, two tactile updates, the
joint objective), loads the JAX-written checkpoint DIR/jax_joint.npz and
writes its own DIR/port_joint.npz; at P = 2 also the Adam ascent, the mesh
session with normals (grid, update, distributed hyperopt, save and
restore) and the CLI's `fit --normals` on a mesh config.  Its results go to
DIR/out<RANK>.npz, with whether jax or any gpis_tpu module was imported.
"""

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.cli.main import main as torch_main
from gpis_tpu_torch.config import MeshConfig, ModelConfig
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.gp import sharded_hyperopt as sho
from gpis_tpu_torch.gp import sharded_joint as gsj
from gpis_tpu_torch.parallel.mesh import make_row_mesh
from gpis_tpu_torch.utils import checkpoint as ckpt


def main(out_dir: str, rank: int, world: int) -> None:
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        run(out_dir, rank, world)
    finally:
        dist.destroy_process_group()


def run(out_dir: str, rank: int, world: int) -> None:
    inp = dict(np.load(f"{out_dir}/inputs.npz"))
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    mesh = make_row_mesh(world, device="cpu")
    block = int(inp["block"])
    params = {"lengthscale": float(inp["ls"]), "signal_variance": float(inp["sv"])}
    out = {}

    out["gram"] = gsj.sharded_joint_gram("rbf", t["x"], params, t["nf"], t["ng"], mesh).numpy()

    model = gsj.fit_sharded_joint("rbf", t["x"], torch.zeros(len(inp["x"]), dtype=torch.float64),
                                  t["nrm"], t["nf"], t["ng"], params, mesh, block=block,
                                  touch_capacity=int(inp["touch_capacity"]))
    out["fit_n0"], out["fit_touch_capacity"] = np.array(model.n0), np.array(model.touch_capacity)
    out["fit_alpha"] = model.alpha.numpy()
    out["fit_mean"], out["fit_var"] = (v.numpy() for v in model.predict(t["q"]))
    out["fit_predict_mean"] = gpr.predict_mean(model, t["q"]).numpy()
    touched = model.update(t["touch_x"][:5], torch.zeros(5, dtype=torch.float64), 1e-5)
    touched = touched.update(t["touch_x"][5:], 0.0, 1e-5)
    out["update_n_touch"] = np.array(touched.n_touch)
    out["update_mean"], out["update_var"] = (v.numpy() for v in touched.predict(t["q"]))
    out["update_l"], out["update_w"] = touched.l.numpy(), touched.w.numpy()
    out["err_overflow"] = np.array(_raises(lambda: touched.update(
        torch.zeros((500, 3), dtype=torch.float64), 0.0, 1e-5)))

    mll, g = sho.sharded_joint_mll_and_grad(
        "rbf", t["mll_x_all"], t["mll_yj"], t["mll_nf_all"], t["mll_ng"], params, mesh,
        c=int(inp["mll_c"]), block=block, n_real=int(inp["mll_n_real"]),
        n_touch=int(inp["mll_n_touch"]), noise_scale=float(inp["mll_scale"]))
    out["mll"] = np.array(float(mll))
    out["mll_grad"] = np.array([float(g[k]) for k in ("log_ls", "log_noise_scale", "log_sv")])

    jm = ckpt.load_model(f"{out_dir}/jax_joint.npz", device="cpu", mesh=mesh)
    out["jax_ckpt_kind"] = np.array(type(jm).__name__)
    out["jax_ckpt_mean"], out["jax_ckpt_var"] = (v.numpy() for v in jm.predict(t["q"]))
    ckpt.save_model(f"{out_dir}/port_joint.npz", touched)

    if world == 2:
        res = sho.optimize_sharded_joint("rbf", model.x, model.y, model.noise_f, model.noise_g,
                                         params, mesh, c=model.n0, block=block,
                                         n_real=model.n_real, steps=2)
        out["opt_history"] = np.array(res["history"])
        out["opt_ls"] = np.array(res["params"]["lengthscale"])
        out["opt_noise_scale"] = np.array(res["noise_scale"])
        session(inp, mesh, world, out_dir, out)

    jax_pkg = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "gpis_tpu" or m.startswith("gpis_tpu.")]
    out["imported"] = np.array(" ".join(jax_pkg))
    np.savez(f"{out_dir}/out{rank}.npz", **out)


def session(inp, mesh, world: int, out_dir: str, out: dict) -> None:
    """The mesh session with normals, its checkpoint, and the CLI."""
    cfg = ModelConfig(kernel="rbf", lengthscale=float(inp["session_ls"]), noise_surface=1e-4,
                      n_external=32, n_internal=1, touch_capacity=8, dtype="float64")
    mesh_cfg = MeshConfig(n_devices=world, block=int(inp["session_block"]))
    sess = ObjectModelSession(cfg, mesh=mesh_cfg, device="cpu")
    # Every rank but 0 passes another cloud: the session fits rank 0's.
    pts = inp["session_pts"] if mesh.rank == 0 else inp["session_pts"][:-7]
    nrm = inp["session_nrm"] if mesh.rank == 0 else inp["session_nrm"][:-7]
    sess.start(pts, normals=nrm)
    out["session_kind"] = np.array(type(sess.model).__name__)
    out["session_mean"], out["session_var"] = sess.query(inp["session_q"])
    grid_mean, grid_var, _ = sess.evaluate_grid(10, 1.5)
    out["session_grid_mean"], out["session_grid_var"] = grid_mean, grid_var
    sess.update(inp["session_touch"])
    out["session_update_mean"], out["session_update_var"] = sess.query(inp["session_q"])
    res = sess.optimize_hyperparameters(method="distributed", steps=2)
    out["session_hyperopt_history"] = np.array(res.history)
    out["session_hyperopt_mean"], out["session_hyperopt_var"] = sess.query(inp["session_q"])
    path = os.path.join(out_dir, "session.npz")
    sess.save(path)
    restored = ObjectModelSession.load(path, cfg, mesh=mesh_cfg, device="cpu")
    out["session_restored_mean"], out["session_restored_var"] = restored.query(
        inp["session_q"])
    out["err_hyperopt"] = np.array(_raises(lambda: sess.optimize_hyperparameters(
        method="stream")))

    os.chdir(out_dir)
    assert torch_main(["fit", "cloudn.npz", "-o", "t_cli.npz", "--normals", "--lengthscale",
                       "0.7", "--noise", "1e-5", "--config", "mesh.json", "--device",
                       "cpu"]) == 0


def _raises(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no exception"


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
