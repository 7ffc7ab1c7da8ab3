"""The port's command line (port of gpis_tpu/cli/main.py): the JAX CLI's
verbs and flags, run on the card unless `--device cpu` is given.

    gpis-torch fit cloud.ply -o model.npz [--kernel rbf --lengthscale 0.7 ...]
    gpis-torch mesh model.npz -o surface.ply [--html surface.html]
    gpis-torch query model.npz --points "x,y,z;x,y,z"
    gpis-torch explore model.npz [--max-charts 64] [--json]
    gpis-torch update model.npz touch.xyz -o model.npz
    gpis-torch hyperopt cloud.ply -o model.npz
    gpis-torch explore-viz model.npz -o viewer.html
    gpis-torch serve model.npz --port 8731
    gpis-torch bench [n_surface]   (the headline fit and 64^3 grid: cli/bench.py)

`python -m gpis_tpu_torch.cli.main ...` is the same command.  Checkpoints
are the JAX package's layout, so either CLI reads the other's models.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from gpis_tpu_torch.cli import add_device_arg


def _add_model_args(p):
    p.add_argument("--kernel", default="rbf",
                   choices=["rbf", "thin_plate", "laplace", "inverse_multiquadric"])
    p.add_argument("--lengthscale", type=float, default=1.0)
    p.add_argument("--signal-variance", type=float, default=1.0)
    p.add_argument("--noise", type=float, default=1e-4)
    p.add_argument("--voxel-leaf", type=float, default=0.0)
    p.add_argument("--config", help="YAML/JSON config file (overridden by flags)")


def _config_from_args(args):
    from gpis_tpu_torch.config import config_from_dict, load_config

    if args.config:
        model_cfg, explore_cfg, mesh_cfg = load_config(args.config)
    else:
        model_cfg, explore_cfg, mesh_cfg = config_from_dict({})
    model_cfg = dataclasses.replace(
        model_cfg,
        kernel=args.kernel,
        lengthscale=args.lengthscale,
        signal_variance=args.signal_variance,
        noise_surface=args.noise,
        voxel_leaf=args.voxel_leaf,
    )
    return model_cfg, explore_cfg, mesh_cfg


def _load_session(args):
    from gpis_tpu_torch.api.session import ObjectModelSession

    return ObjectModelSession.load(args.model, device=args.device)


def _parser():
    ap = argparse.ArgumentParser(prog="gpis-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("fit", help="fit a GPIS model from a point cloud")
    p.add_argument("cloud")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--normals", action="store_true",
                   help="use surface normals from the cloud file as derivative observations")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the fit to DIR, and the "
                        "port's spans and counters beside it as spans.<pid>.<ns>.json")
    p.add_argument("--out-of-core", action="store_true",
                   help="panel-streamed fit for clouds whose factor exceeds the card's "
                        "memory; the checkpoint's W panels land beside the output in "
                        "OUTPUT.w/")
    p.add_argument("--experts", type=int, default=0, metavar="E",
                   help="fit an E-expert local-GP committee (rBCM) instead of the exact GP "
                        "(the fast approximate path for 100k-class clouds)")
    p.add_argument("--expert-gate", type=int, default=0, metavar="G",
                   help="evaluate only the G nearest experts per query chunk (0 = all)")
    _add_model_args(p)

    p = sub.add_parser("mesh", help="extract isosurface mesh from a model")
    p.add_argument("model")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--extent", type=float, default=1.6)
    p.add_argument("--html", help="also write a self-contained HTML viewer")

    p = sub.add_parser("query", help="posterior mean/variance at points")
    p.add_argument("model")
    p.add_argument("--points", required=True, help='"x,y,z;x,y,z;..."')

    p = sub.add_parser("explore", help="compute next-best tactile path")
    p.add_argument("model")
    p.add_argument("--max-charts", type=int, default=64)
    p.add_argument("--json", action="store_true", help="machine-readable output")

    p = sub.add_parser("update", help="append tactile points and refit")
    p.add_argument("model")
    p.add_argument("touches", help="cloud file of touch points")
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("hyperopt", help="fit + optimize hyperparameters")
    p.add_argument("cloud")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--method", choices=["subsample", "distributed", "stream"],
                   default="subsample",
                   help="'distributed' (sharded models): exact mesh-wide MLL ascent "
                        "(gp.sharded_hyperopt); 'stream' (--out-of-core): exact full-data "
                        "ascent at one panel-streamed factorization per step "
                        "(gp.ooc_hyperopt); default is the single-card subsample")
    p.add_argument("--normals", action="store_true",
                   help="fit the joint (derivative-observation) model from the cloud's "
                        "normals before optimizing")
    p.add_argument("--out-of-core", action="store_true",
                   help="fit through the panel-streamed out-of-core path before optimizing")
    p.add_argument("--learn-noise", action="store_true",
                   help="also learn a value-observation noise scale")
    p.add_argument("--learn-noise-g", action="store_true",
                   help="joint (--normals) models: also learn a gradient-observation noise "
                        "scale")
    p.add_argument("--learn-signal", action="store_true",
                   help="also learn the signal variance")
    _add_model_args(p)

    p = sub.add_parser("explore-viz", help="export mesh+charts+path HTML viewer")
    p.add_argument("model")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--resolution", type=int, default=32)

    p = sub.add_parser("bench", help="run the headline benchmark (one JSON line)")
    p.add_argument("n_surface", nargs="?", type=int, default=None)
    p.add_argument("--save-grid", metavar="PATH",
                   help="also write the timed round's 64^3 mean and variance to PATH (.npz)")

    p = sub.add_parser("serve", help="serve the JSON API")
    p.add_argument("model", nargs="?", help="optional checkpoint to preload")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8731)
    _add_model_args(p)

    for p in sub.choices.values():
        add_device_arg(p)
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    # Friendly errors for missing inputs (no tracebacks at the CLI surface).
    for attr in ("cloud", "model", "touches"):
        path = getattr(args, attr, None)
        if path and not os.path.exists(path):
            raise SystemExit(f"error: {attr} file not found: {path}")

    # Imports deferred past argparse so `gpis-torch -h` is instant.
    from gpis_tpu_torch.api.session import ObjectModelSession
    from gpis_tpu_torch.data.io import load_cloud

    if args.cmd == "fit":
        from gpis_tpu_torch.utils.profiling import trace

        model_cfg, explore_cfg, mesh_cfg = _config_from_args(args)
        pts, nrm = load_cloud(args.cloud)
        if args.normals and nrm is None:
            raise SystemExit(f"--normals given but {args.cloud} has no normals")
        sess = ObjectModelSession(model_cfg, explore_cfg, mesh_cfg, device=args.device)
        with trace(args.profile):
            sess.start(pts, normals=nrm if args.normals else None,
                       out_of_core=args.out_of_core, experts=args.experts,
                       expert_gate=args.expert_gate)
        sess.save(args.output)
        print(f"model saved to {args.output} (capacity {sess.model.capacity})"
              + (f"; trace -> {args.profile}" if args.profile else ""))

    elif args.cmd == "mesh":
        from gpis_tpu_torch.viz.export import export_html, export_isosurface_ply

        sess = _load_session(args)
        verts, faces, var = sess.extract_surface(args.resolution, args.extent)
        export_isosurface_ply(args.output, verts, faces, variance=var)
        print(f"mesh: {len(verts)} verts, {len(faces)} faces -> {args.output}")
        if args.html:
            export_html(args.html, verts, faces, variance=var)
            print(f"viewer -> {args.html}")

    elif args.cmd == "query":
        sess = _load_session(args)
        pts = np.array([[float(v) for v in p.split(",")] for p in args.points.split(";")])
        mean, var = sess.query(pts)
        for p_, m, v in zip(pts, mean, var):
            print(f"{p_[0]:+.4f},{p_[1]:+.4f},{p_[2]:+.4f}  f={m:+.6f}  var={v:.6e}")

    elif args.cmd == "explore":
        sess = _load_session(args)
        sess.explore_config = dataclasses.replace(sess.explore_config,
                                                  max_charts=args.max_charts)
        res = sess.next_best_path()
        if args.json:
            print(json.dumps({
                "path": res.path.tolist(), "normals": res.normals.tolist(),
                "target_variance": float(res.target_variance),
                "reached_threshold": bool(res.reached_threshold),
            }))
        else:
            print(f"path with {len(res.path)} poses; target variance "
                  f"{res.target_variance:.4f} (threshold reached: {res.reached_threshold})")
            for p_, n in zip(res.path, res.normals):
                print(f"  at {p_.round(4).tolist()} normal {n.round(4).tolist()}")

    elif args.cmd == "update":
        sess = _load_session(args)
        pts, _ = load_cloud(args.touches)
        sess.update(pts)
        sess.save(args.output)
        print(f"updated with {len(pts)} touches -> {args.output}")

    elif args.cmd == "hyperopt":
        model_cfg, explore_cfg, mesh_cfg = _config_from_args(args)
        pts, nrm = load_cloud(args.cloud)
        if args.normals and nrm is None:
            raise SystemExit(f"--normals given but {args.cloud} has no normals")
        sess = ObjectModelSession(model_cfg, explore_cfg, mesh_cfg, device=args.device).start(
            pts, normals=nrm if args.normals else None, out_of_core=args.out_of_core)
        kw = {"steps": args.steps}
        if args.method != "subsample":
            # Explicitly requested methods go through; the session raises
            # on a model they do not fit (no silent downgrade).
            kw["method"] = args.method
        for flag in ("learn_noise", "learn_noise_g", "learn_signal"):
            if getattr(args, flag):
                kw[flag] = True
        res = sess.optimize_hyperparameters(**kw)
        sess.save(args.output)
        print(f"mll={res.mll:.4f} lengthscale={float(res.params['lengthscale']):.4f} "
              f"-> {args.output}")

    elif args.cmd == "explore-viz":
        sess = _load_session(args)
        res = sess.export_exploration(args.output, resolution=args.resolution)
        print(f"viewer with {len(res.charts)} charts + {len(res.path)}-pose path "
              f"-> {args.output}")

    elif args.cmd == "bench":
        from gpis_tpu_torch.cli import bench

        argv = [] if args.n_surface is None else [str(args.n_surface)]
        if args.save_grid:
            argv += ["--save-grid", args.save_grid]
        return bench.main(argv + ["--device", args.device])

    elif args.cmd == "serve":
        from gpis_tpu_torch.api.service import serve

        model_cfg, explore_cfg, mesh_cfg = _config_from_args(args)
        if args.model:
            sess = ObjectModelSession.load(args.model, model_cfg, device=args.device)
        else:
            sess = ObjectModelSession(model_cfg, explore_cfg, mesh_cfg, device=args.device)
        serve(sess, args.host, args.port)

    return 0


if __name__ == "__main__":
    sys.exit(main())
