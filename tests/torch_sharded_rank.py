"""One rank of the port's row-sharded pipeline on the CPU (gloo), for
tests/test_torch_sharded.py.  It imports torch and gpis_tpu_torch only.

    python tests/torch_sharded_rank.py DIR RANK WORLD

reads DIR/inputs.npz, joins a gloo group through the file store
DIR/store (collectives time out after 60 s, so a hung one ends the rank),
runs every sharded function on the inputs, the tactile update with them,
at P = 2 the distributed MLL objective and the session's hyperopt methods
(and predicts from the JAX model's arrays, the `jm_*` inputs, and from
those of the JAX model after an update, `jmt_*`, through `convert`) and
writes its results to DIR/out<RANK>.npz: its bands of the sharded outputs, the replicated ones
whole, the messages of the calls that must raise, and whether jax or any
gpis_tpu module was imported.
"""

import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

from gpis_tpu_torch import convert
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import MeshConfig, ModelConfig
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.gp import sharded_hyperopt as sho
from gpis_tpu_torch.gp import sharded_model as gsm
from gpis_tpu_torch.linalg import sharded as sh
from gpis_tpu_torch.parallel.mesh import make_row_mesh


def _raises(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no exception"


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
    row0, rows = mesh.band(t["x"].shape[0])
    band = slice(row0, row0 + rows)
    out = {}

    a = sh.sharded_gram("rbf", t["x"], params, t["noise"], mesh)
    out["gram"] = a.numpy().copy()
    out["chol"] = sh.sharded_cholesky(a, mesh, block=block).numpy()
    a = sh.sharded_gram("rbf", t["x"], params, t["noise"], mesh)
    out["chol_kernels"] = sh.sharded_cholesky(a, mesh, block=block, use_kernels=True).numpy()

    l_loc = t["l"][band].contiguous()
    out["solve_lower"] = sh.sharded_solve_lower_vec(l_loc, t["y"], mesh, block=block).numpy()
    out["solve_lower_t"] = sh.sharded_solve_lower_t_vec(l_loc, t["y"], mesh, block=block).numpy()
    out["cho_solve"] = sh.sharded_cho_solve_vec(l_loc, t["y"], mesh, block=block).numpy()
    out["linv"] = sh.sharded_linv(l_loc, mesh, block=block).numpy()
    out["linv_kernel"] = sh.sharded_linv(l_loc, mesh, block=block, use_kernel=True).numpy()
    out["linv_ll"] = sh.sharded_linv_ll(l_loc, mesh, block=block).numpy()

    w_loc = t["w"][band].contiguous()
    alpha = sh.sharded_alpha_from_linv(w_loc, t["y"], mesh)
    out["alpha"] = alpha.numpy()
    mean, var = sh.sharded_predict_linv("rbf", t["q"], t["x"], params, t["alpha"], w_loc, mesh)
    out["predict_mean"], out["predict_var"] = mean.numpy(), var.numpy()

    model = gsm.fit_sharded("rbf", t["x"], t["y"], t["noise"], params, mesh, block=block,
                            touch_capacity=int(inp["touch_capacity"]))
    mean, var = gpr.predict(model, t["q_odd"])
    out["fit_capacity"] = np.array(model.capacity)
    out["fit_alpha"] = model.alpha.numpy()
    out["fit_mean"], out["fit_var"] = mean.numpy(), var.numpy()
    touched = model.update(t["touch_x"][:5], t["touch_y"][:5], 1e-6)
    touched = touched.update(t["touch_x"][5:], 0.0, 1e-6)
    out["update_n_touch"] = np.array(touched.n_touch)
    out["update_l"], out["update_w"] = touched.l.numpy(), touched.w.numpy()
    out["update_alpha"] = touched.alpha.numpy()
    out["update_mean"], out["update_var"] = (v.numpy() for v in gpr.predict(touched, t["q_odd"]))
    room = model.capacity - max(model.n_real, model.capacity - rows)
    out["err_update"] = np.array(_raises(lambda: model.update(t["q"][:room + 1], 0.0, 1e-6)))

    jax_model = {k[3:]: v for k, v in inp.items() if k.startswith("jm_")}
    converted = convert.sharded_model_from_arrays(jax_model, mesh, kernel="rbf", params=params,
                                                  block=block, n_real=int(inp["jm_n_real"]))
    out["converted_mean"], out["converted_var"] = (
        v.numpy() for v in gpr.predict(converted, t["q_odd"]))
    touched_jax = {k[4:]: v for k, v in inp.items() if k.startswith("jmt_")}
    converted = convert.sharded_model_from_arrays(touched_jax, mesh, kernel="rbf", params=params,
                                                  block=block, n_real=int(inp["jm_n_real"]),
                                                  n_touch=int(inp["jmt_n_touch"]))
    converted = converted.update(t["touch_x"][5:], 0.0, 1e-6)
    out["converted_update_mean"], out["converted_update_var"] = (
        v.numpy() for v in gpr.predict(converted, t["q_odd"]))

    cfg = ModelConfig(kernel="rbf", lengthscale=float(inp["session_ls"]), noise_surface=1e-4,
                      n_external=32, n_internal=1, dtype="float64")
    mesh_cfg = MeshConfig(n_devices=world, block=int(inp["session_block"]))
    sess = ObjectModelSession(cfg, mesh=mesh_cfg, device="cpu")
    # Every rank but 0 passes a cloud of another size: the session fits rank 0's.
    pts = inp["session_pts"] if rank == 0 else inp["session_pts"][:-7]
    sess.start(pts)
    out["session_capacity"] = np.array(sess.model.capacity)
    out["session_mean"], out["session_var"] = sess.query(inp["session_q"])
    grid_mean, grid_var, _ = sess.evaluate_grid(12, 1.5)
    out["session_grid_mean"], out["session_grid_var"] = grid_mean, grid_var
    sess.update(inp["session_touch"])
    out["session_update_mean"], out["session_update_var"] = sess.query(inp["session_q"])

    if world == 2:
        hyperopt(inp, t, mesh, cfg, mesh_cfg, out)

    out["err_world"] = np.array(_raises(lambda: ObjectModelSession(
        cfg, mesh=MeshConfig(n_devices=world + 1), device="cpu")))
    out["err_out_of_core"] = np.array(_raises(lambda: sess.start(pts, out_of_core=True)))
    out["err_normals"] = np.array(_raises(lambda: sess.start(pts, normals=pts)))

    jax_pkg = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "gpis_tpu" or m.startswith("gpis_tpu.")]
    out["imported"] = np.array(" ".join(jax_pkg))
    np.savez(f"{out_dir}/out{rank}.npz", **out)


def hyperopt(inp, t, mesh, cfg, mesh_cfg, out) -> None:
    """The distributed MLL objective and the session's two hyperopt methods."""
    params = {"lengthscale": float(inp["ls"]), "signal_variance": float(inp["sv"])}
    mll, g = sho.sharded_mll_and_grad("rbf", t["x"], t["y"], t["noise"], params, mesh,
                                      block=int(inp["block"]), n_real=int(inp["mll_n_real"]),
                                      noise_scale=float(inp["mll_scale"]))
    out["mll"] = np.array(float(mll))
    out["mll_grad"] = np.array([float(g[k]) for k in ("log_ls", "log_noise_scale", "log_sv")])
    for method in ("distributed", "subsample"):
        sess = ObjectModelSession(cfg, mesh=mesh_cfg, device="cpu").start(inp["session_pts"])
        kw = {"subsample": 64} if method == "subsample" else {}
        res = sess.optimize_hyperparameters(method=method, steps=2, **kw)
        out[f"hyperopt_{method}_history"] = np.array(res.history)
        out[f"hyperopt_{method}_ls"] = np.array(res.params["lengthscale"])
        out[f"hyperopt_{method}_mean"], out[f"hyperopt_{method}_var"] = sess.query(
            inp["session_q"])
    out["err_hyperopt"] = np.array(_raises(lambda: sess.optimize_hyperparameters(method="stream")))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
