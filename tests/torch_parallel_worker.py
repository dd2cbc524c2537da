"""One rank of the 2-process ``gloo`` world of ``test_torch_parallel.py``.

Run as ``python torch_parallel_worker.py OUTDIR`` under the ``torchrun``
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``). It joins the world through
``parallel.mesh.maybe_initialize_distributed``, runs every check of the
test file on the CPU and saves what it found to ``OUTDIR/rank<r>.pt`` for
the tests to read. It imports no JAX: the JAX references are computed by
the tests."""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fourk_nerf_torch import weights  # noqa: E402
from fourk_nerf_torch.models import dmpigo, dvgo, sr_esrnet  # noqa: E402
from fourk_nerf_torch.ops import box_sweep, cuda_box  # noqa: E402
from fourk_nerf_torch.parallel import mesh as pm  # noqa: E402
from fourk_nerf_torch.utils import misc  # noqa: E402


def _dp_forward(mesh, cfg, params, buffers, rays):
    """The forward with the rays split over ``data`` and the params
    replicated, the outputs gathered whole."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    rep = {k: ({n: distribute_tensor(w, mesh, pm.replicate(mesh))
                for n, w in v.items()} if isinstance(v, dict)
               else distribute_tensor(v, mesh, pm.replicate(mesh)))
           for k, v in params.items()}
    local = [distribute_tensor(r, mesh, pm.shard_batch(mesh)).to_local()
             for r in rays]
    out = dmpigo.forward(cfg, rep, buffers, *local, stepsize=1.0, bg=0.5,
                         ndc_planes=True)
    return {k: DTensor.from_local(out[k].contiguous(), mesh,
                                  pm.shard_batch(mesh)).full_tensor()
            for k in ("rgb_marched", "alphainv_last")}


def main(outdir: str) -> None:
    torch.set_num_threads(1)
    assert pm.maybe_initialize_distributed(True, device="cpu")
    rank = torch.distributed.get_rank()
    res: dict = {"master": pm.is_master()}
    scene = torch.load(os.path.join(outdir, "scene.pt"), weights_only=False)

    # --- meshes -------------------------------------------------------------
    dp = pm.make_mesh(device="cpu")
    gp = pm.make_mesh(n_data=1, n_grid=2, device="cpu")
    res["mesh_shapes"] = [tuple(dp.shape), tuple(gp.shape)]
    res["mesh_names"] = [dp.mesh_dim_names, gp.mesh_dim_names]

    # --- DirectMPIGO: data-parallel, then grid-sharded with its gradient -----
    cfg = dmpigo.make_config(**scene["dmpigo_kw"])
    params, buffers = weights.dmpigo_from_numpy(scene["dmpigo_params"],
                                                scene["dmpigo_buffers"],
                                                device="cpu")
    rays = [torch.as_tensor(a) for a in scene["rays"]]
    res["dp"] = _dp_forward(dp, cfg, params, buffers, rays)
    sharded = pm.shard_grid_params(gp, params)
    res["grid_local_x"] = sharded["density"].to_local().shape[0]
    leaves = [sharded["density"], sharded["k0"]]
    for t in leaves:
        t.requires_grad_(True)
    out = dmpigo.forward(cfg, sharded, buffers, *rays, stepsize=1.0, bg=0.5,
                         ndc_planes=True)
    res["grid"] = {k: out[k].detach() for k in ("rgb_marched",
                                                "alphainv_last")}
    out["rgb_marched"].sum().backward()
    res["grid_grads"] = [t.grad.full_tensor() for t in leaves]

    # --- all_reduce_dict ------------------------------------------------------
    res["all_reduce"] = pm.all_reduce_dict(dp, {
        "loss": float(rank + 1), "vec": torch.tensor([rank, 2.0 * rank]),
        "nested": {"host": 3.0}})

    # --- replica consistency ----------------------------------------------------
    rep = pm.shard_grid_params(gp, params)
    tree = {"grids": rep, "plain": torch.arange(4.0)}
    misc.check_replica_consistency(tree)  # must pass
    errors = []
    bad = {"plain": torch.arange(4.0) + (1e-6 if rank == 1 else 0.0)}
    for t in (bad, {"net": {"w": rep["rgbnet"]["w0"].__class__.from_local(
            rep["rgbnet"]["w0"].to_local() + (rank == 1), gp,
            rep["rgbnet"]["w0"].placements)}}):
        try:
            misc.check_replica_consistency(t)
            errors.append(None)
        except AssertionError as e:
            errors.append(str(e))
    res["replica_errors"] = errors

    # --- tile_process_sharded ----------------------------------------------------
    model = weights.sftnet_from_flax(scene["sftnet"], device="cpu")
    img, cond = (torch.as_tensor(a) for a in scene["sr_input"])

    def apply_fn(x, c):
        with torch.no_grad():
            return model(x, c)

    res["tile_sharded"] = sr_esrnet.tile_process_sharded(
        apply_fn, img, cond, 8, dp, tile_pad=2, scale=2)
    res["tile_plain"] = sr_esrnet.tile_process(apply_fn, img, cond, 8,
                                               tile_pad=2, scale=2)

    # --- render_frame_box(tile_mesh=...) through the plain version --------------
    bcfg = dvgo.make_config(**scene["dvgo_kw"])
    bp, bb = weights.dvgo_from_numpy(scene["dvgo_params"],
                                     scene["dvgo_buffers"], device="cpu")
    kw = dict(stepsize=0.5, near=2.0, bg=1.0, use_bf16=False, device="cpu")
    K, c2w = scene["box_camera"]
    res["box_sharded"] = box_sweep.render_frame_box(
        bcfg, bp, bb, 17, 19, K, c2w, tile_mesh=dp, **kw)
    res["box_plain"] = cuda_box.render_frame_box_cuda(bcfg, bp, bb, 17, 19,
                                                      K, c2w, **kw)
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
