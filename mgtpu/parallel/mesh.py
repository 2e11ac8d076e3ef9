"""Device-mesh data parallelism.

The JAX replacement for the reference's multi-GPU layer
(`/root/reference/multigpu.lua`): where Torch needed
nn.DataParallelTable + NCCL + explicit syncParameters
(`multigpu.lua:81-103`, `pipelines/standard/train.lua:165-169`), here a
`jax.sharding.Mesh` with the batch dim sharded over the 'data' axis and
params replicated makes XLA insert the gradient all-reduce (NCCL on
GPUs) automatically — scatter, reduce, and broadcast all disappear into
the compiler. The mesh carries a second axis (size 1 unless -spatial or
-tensor) for spatial / channel sharding. The cards of one host are
joined all to all, so the mesh is a plain reshape of the device list."""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_multihost() -> None:
    """Multi-host bootstrap (-multihost): join the jax.distributed
    coordination service so jax.devices() becomes the GLOBAL device set
    across processes (the reference was single-host,
    `multigpu.lua:85`). The endpoint comes from MGTPU_COORDINATOR
    (host:port) / MGTPU_NUM_PROCESSES / MGTPU_PROCESS_ID; there is no
    cluster auto-detection to fall back on."""
    missing = [k for k in ("MGTPU_COORDINATOR", "MGTPU_NUM_PROCESSES",
                           "MGTPU_PROCESS_ID") if not os.environ.get(k)]
    if missing:
        raise SystemExit(
            f"-multihost needs {', '.join(missing)}: set MGTPU_COORDINATOR "
            "to host:port of process 0, MGTPU_NUM_PROCESSES and "
            "MGTPU_PROCESS_ID on every process"
        )
    jax.distributed.initialize(
        coordinator_address=os.environ["MGTPU_COORDINATOR"],
        num_processes=int(os.environ["MGTPU_NUM_PROCESSES"]),
        process_id=int(os.environ["MGTPU_PROCESS_ID"]),
    )
    print(
        f"==> multihost: process {jax.process_index()}/{jax.process_count()}, "
        f"{jax.local_device_count()} local / {jax.device_count()} global devices"
    )


def is_primary() -> bool:
    """True on the process that owns run artifacts (checkpoints, h5
    dumps). Single-host (the reference's scope, `multigpu.lua:85`) is
    always primary; under -multihost only process 0 writes — params are
    replicated across processes, so its copy is canonical."""
    return jax.process_index() == 0


def fetch_global(x) -> np.ndarray:
    """Fetch a (possibly multi-process-sharded) array to host numpy.

    Single-process: plain np.asarray. Multi-process: a global array's
    shards live on other hosts, so np.asarray would raise
    (non-addressable); all-gather the batch shards across processes first —
    every process gets the full value, keeping the eval loop SPMD (all
    processes take the same branches on the result)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def gather_tree(tree):
    """Collective, D2H-safe view of a pytree for checkpointing. Leaves
    whose shards span OTHER processes — tensor-sharded params/momentum
    under `-multihost -tensor` — are all-gathered across processes to full
    numpy values; fully-addressable or fully-replicated leaves pass
    through untouched (zero cost single-host). EVERY process must call
    this at the same program point (the gather is a collective); only
    the subsequent WRITE is gated on is_primary()."""
    if jax.process_count() == 1:
        return tree
    from jax.experimental import multihost_utils

    def g(x):
        if isinstance(x, jax.Array) and not (
            x.is_fully_addressable or x.is_fully_replicated
        ):
            return np.asarray(multihost_utils.process_allgather(x, tiled=True))
        return x

    return jax.tree.map(g, tree)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices=None,
              model_axis: str = "model") -> Mesh:
    """data × model device mesh. ``model_axis`` names the second axis
    and encodes its use: 'model' = spatial H-sharding (-spatial, the
    constrain_spatial path), 'tensor' = channel sharding (-tensor, the
    shard_params_tp path). The name is what keeps the two modes from
    fighting: constrain_spatial only fires on a 'model' axis."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_model
    use = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(use, ("data", model_axis))


def _put(x, sh: NamedSharding):
    """device_put that also works when the mesh spans processes: every
    process holds the full host value (loaders are seed-deterministic,
    params are identically initialized), and the callback hands each
    addressable shard its global slice."""
    if jax.process_count() > 1:
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])
    return jax.device_put(x, sh)


def batch_sharding(mesh: Mesh, batch_axis: int = 0) -> NamedSharding:
    spec = [None] * (batch_axis + 1)
    spec[batch_axis] = "data"
    return NamedSharding(mesh, P(*spec))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree, batch_axis: int = 0, spatial: bool = False):
    """Place host arrays on the mesh with the batch dim split over
    'data'. Batch size must divide the data-axis size.

    With ``spatial=True`` (the CNN analog of sequence parallelism —
    SURVEY §5 reserves the 'model' axis for exactly this), image-shaped
    leaves additionally split their HEIGHT dim — the third-from-last
    axis of the trailing (H, W, C) — over the 'model' axis. XLA's GSPMD partitioner then inserts the halo
    exchanges the 3x3 convs and 2x2 pools need at shard boundaries —
    the same compiler mechanism that inserts the gradient psum for the
    'data' axis, so no hand-written collectives appear here either.
    Leaves without spatial extent beyond the batch dim (labels) stay
    batch-sharded only; segmentation targets (..., H, W, C) split like
    images so the elementwise loss stays local."""

    def put(x):
        spec = [None] * max(x.ndim, batch_axis + 1)
        spec[batch_axis] = "data"
        if spatial and mesh.shape["model"] > 1 and x.ndim >= batch_axis + 4:
            # height = third-from-last of the trailing (H, W, C) — robust
            # to leading iter-size and ten-crop axes ((iter,B,H,W,C) and
            # (B,10,H,W,C) both resolve to the true H, where
            # batch_axis+1 would hit the crop axis of ten-crop batches)
            spec[x.ndim - 3] = "model"
        return _put(x, NamedSharding(mesh, P(*spec[: x.ndim])))

    return jax.tree.map(put, tree)


def constrain_spatial(x):
    """Pin an NHWC activation's 'model'-axis sharding under -spatial.

    GSPMD left alone will propagate the input's H-sharding all the way
    down the pyramid, including to 1-row coarse scales, where it takes
    its own "last-resort replicate" path (spmd_partitioner.cc warning)
    — which is both slow and, measured on the 8-device virtual mesh,
    NUMERICALLY WRONG for this model (train-step loss 5.8307 vs 5.9200
    replicated). So: H is split over 'model' only while each shard
    keeps >= 8 rows and the 2x2 halo exchanges stay aligned
    (H % 2*n_model == 0); every coarser scale is explicitly replicated
    over 'model'. This is also the right perf shape — the fine grids
    carry ~all the FLOPs, the coarse ones are cheaper than their halo
    traffic. No-op unless a mesh with a >1 'model' axis is active."""
    mesh = jax.sharding.get_abstract_mesh()
    if mesh is None or "model" not in mesh.shape or mesh.shape["model"] == 1:
        return x
    if not hasattr(x, "ndim") or x.ndim != 4:
        return x
    nm = mesh.shape["model"]
    h = x.shape[1]
    U = P.UNCONSTRAINED
    h_spec = "model" if (h % (2 * nm) == 0 and h // nm >= 8) else None
    return jax.lax.with_sharding_constraint(x, P(U, h_spec, U, U))


def constrain_pyramid(pyr):
    """constrain_spatial over a tuple-of-arrays pyramid."""
    return tuple(constrain_spatial(x) for x in pyr)


def replicate(mesh: Mesh, tree):
    sh = replicated_sharding(mesh)
    return jax.tree.map(lambda x: _put(x, sh), tree)


def tp_sharding(mesh: Mesh, x) -> NamedSharding:
    """Channel sharding for one param/stat/momentum leaf under -tensor:
    split the TRAILING dim — a conv kernel's O (HWIO), a BN
    scale/bias/running-stat's C — over the 'tensor' axis. Leaves whose
    trailing dim doesn't divide, or would drop below 8 channels per
    shard (the GSPMD small-shard cliff found with -spatial — see
    constrain_spatial), stay replicated; correctness never depends on
    which leaves end up sharded."""
    nt = mesh.shape["tensor"]
    if (
        nt > 1
        and getattr(x, "ndim", 0) >= 1
        and x.shape[-1] % nt == 0
        and x.shape[-1] // nt >= 8
    ):
        return NamedSharding(mesh, P(*([None] * (x.ndim - 1) + ["tensor"])))
    return NamedSharding(mesh, P())


def zero1_spec(x, n_data: int) -> P:
    """PartitionSpec for one SGD-momentum leaf under -zero1 (ZeRO-1
    optimizer-state sharding): split the TRAILING dim — a conv kernel's
    O (HWIO), a BN scale/bias's C — over the 'data' axis, so each chip
    stores 1/N of the momentum buffer. Unlike tp_sharding there is no
    minimum-channels-per-shard rule: the momentum only feeds elementwise
    update math and one all-gather, never a conv, so the GSPMD
    small-shard cliff doesn't apply. Leaves whose trailing dim doesn't
    divide n_data stay replicated; correctness never depends on which
    leaves end up sharded."""
    if (
        n_data > 1
        and getattr(x, "ndim", 0) >= 1
        and x.shape[-1] % n_data == 0
    ):
        return P(*([None] * (x.ndim - 1) + ["data"]))
    return P()


def shard_opt_zero1(mesh: Mesh, tree):
    """Place an SGD opt-state pytree for -zero1 runs: every eligible
    momentum leaf sharded over 'data' (optimizer memory scales 1/nGPU —
    the ZeRO stage-1 contract), the rest replicated. The reference has
    no analog (optim.sgd keeps full momentum per GPU inside one host,
    `pipelines/standard/train.lua:49-55`); this is the
    scaling feature the 'data' axis gives for free: XLA turns the
    gradient all-reduce into reduce-scatter(+local update)+all-gather
    where profitable, and the sharded layout is re-asserted inside the
    train step (mgtpu/train/step.py) so it survives the update."""
    return jax.tree.map(
        lambda x: _put(x, NamedSharding(mesh, zero1_spec(x, mesh.shape["data"]))),
        tree,
    )


def shard_params_tp(mesh: Mesh, tree):
    """Place a params/stats/opt-state pytree for -tensor runs: every
    eligible leaf channel-sharded over 'tensor' (tensor parallelism:
    each device owns an output-channel slice of every conv and its BN,
    and the matching slice of the SGD momentum — param, grad, and
    optimizer memory all scale down 1/N), the rest replicated. XLA's
    GSPMD propagates the layout through the forward/backward and
    inserts the collectives (channel all-gathers where a conv consumes
    a sharded activation, psums where it contracts one)."""
    return jax.tree.map(lambda x: _put(x, tp_sharding(mesh, x)), tree)
