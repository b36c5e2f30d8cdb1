"""Distribution — data- and tensor-parallel training over torch.distributed.

Port of the data- and tensor-parallel half of
``veles_tpu/parallel/__init__.py``.  The reference runs one process over
a ``(data, model)`` mesh of devices and lets GSPMD insert the
collectives; PyTorch's idiom is one process a device, so here the mesh
is the ``torch.distributed`` world laid out as a ``(data, model)`` grid
of ranks (rank = data index · model_parallel + model index), with one
process group a row (the model group) and one a column (the data group).

- **Joining** (:func:`initialize_multihost`): a TCP store at the
  coordinator's address; rank r runs on ``cuda:(r % device_count)``
  (or the CPU when asked).  Backend: NCCL when every rank has a card of
  its own, gloo when ranks share a card or run on the CPU — decided at
  call time from what every rank reports to the store, logged and
  returned.  No environment variable chooses it; an NCCL set-up that
  fails raises.
- **Data parallelism** (:class:`ShardedTrainer`): each rank runs the
  fused runner's gradients on its rows, then ONE flat ``all_reduce(SUM)``
  over the data group carries every gradient sum and the metric sums
  (``*_max`` metrics take a ``MAX``), and every rank applies the same
  one-launch fused-SGD update with ``inv_batch = 1 / global batch`` —
  so the replicas stay bit-equal.  This is the reference's master-side
  gradient averaging (``veles/server.py`` [H]), synchronous.
- **Tensor parallelism** of ``model_shard_layers`` (the reference's
  last-axis split, ``veles_tpu/parallel/__init__.py:106-121``): model
  rank r keeps output columns (channels) [r·n/m, (r+1)·n/m) of the
  layer's weights, bias and velocities; the forward all-gathers the
  local products along the last axis over the model group, the backward
  takes the rank's slice of the error and sums the partial input
  gradients with an ``all_reduce``.
- **Random draws**: a stochastic layer on data rank r draws exactly the
  rows of the global batch's draws (``functional.RowShard``): dropout
  hashes with an element offset, a crop keeps its rows of the global
  batch's draws — the reference's partitionable threefry
  (``veles_tpu/compat.py:11-26``).
- **Expert parallelism** (``ops/moe.py::moe_ffn_ep``, the reference's
  ``moe_ffn_ep``): a mesh laid out as ``("data", "expert")`` names its
  row group by the expert axis (:meth:`Mesh.group`); each rank's
  experts' shares are summed by :func:`ep_all_reduce`, and their input
  gradients by :func:`ep_input_grad_all_reduce`.
- **Pipeline stages and ring attention** (``parallel/pipeline.py``,
  ``parallel/ring.py``): neighbours exchange activations, gradients and
  K/V blocks through :func:`p2p_exchange`; the stages' outputs and
  input gradients, and the ring's output blocks and input gradients,
  through the counted collectives below.

Under NCCL the epoch scan's captured step holds the collectives inside
the CUDA graph; a gloo collective stages through the host and cannot be
captured, so the scan on the card needs NCCL (it raises under gloo); on
the CPU it runs eagerly under gloo.
"""

from __future__ import annotations

import datetime
import socket
import zlib

import numpy
import torch
import torch.distributed as dist

from veles_tpu_torch.logger import Logger

#: this process's run once joined: its device and backend
_JOINED = {}

#: the store's and the collectives' time limit
TIMEOUT = datetime.timedelta(seconds=600)


# ------------------------------------------------------------ collectives
def _collective(run, tensor, group):
    """``run()`` — a blocking collective on ``tensor`` over ``group``.
    gloo stages a card tensor through the host on streams of its own:
    the card's work on the operands is finished before it starts and
    its copy back before the result is read (without the two waits two
    ranks sharing a card read each other's partial results)."""
    staged = tensor.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        torch.cuda.current_stream(tensor.device).synchronize()
    run()
    if staged:
        torch.cuda.synchronize(tensor.device)


def grad_all_reduce(bucket, group):
    """One train step's gradient sums and metric sums, one flat fp32
    bucket, summed over the data group in place."""
    _collective(lambda: dist.all_reduce(bucket, op=dist.ReduceOp.SUM,
                                        group=group), bucket, group)
    grad_all_reduce.launches += 1


def metric_all_reduce(bucket, group, op=dist.ReduceOp.SUM):
    """An eval step's metric sums (or a step's ``*_max`` metrics with
    ``op`` MAX), summed over the data group in place."""
    _collective(lambda: dist.all_reduce(bucket, op=op, group=group),
                bucket, group)
    metric_all_reduce.launches += 1


def tp_all_gather(y, group, parts):
    """A split layer's local outputs gathered along the last axis over
    the model group (``parts`` ranks)."""
    out = [torch.empty_like(y) for _ in range(parts)]
    _collective(lambda: dist.all_gather(out, y, group=group), y, group)
    tp_all_gather.launches += 1
    return torch.cat(out, dim=-1)


def tp_input_grad_all_reduce(err, group):
    """A split layer's partial input gradient summed over the model
    group in place."""
    _collective(lambda: dist.all_reduce(err, op=dist.ReduceOp.SUM,
                                        group=group), err, group)
    tp_input_grad_all_reduce.launches += 1


class _ExpertSum(torch.autograd.Function):
    """The experts' shares summed over the expert group.  Its backward
    passes the cotangent on as it is: the loss is replicated, so every
    rank holds the sum's whole cotangent already (summing it again would
    scale the experts' gradients by the group size)."""

    @staticmethod
    def forward(ctx, local, group):
        out = local.contiguous().clone()
        _collective(lambda: dist.all_reduce(out, op=dist.ReduceOp.SUM,
                                            group=group), out, group)
        ep_all_reduce.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ExpertInput(torch.autograd.Function):
    """The experts' input: the identity forward; the backward sums the
    ranks' partial input gradients (each rank's experts give one share)
    over the expert group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _collective(lambda: dist.all_reduce(
            grad, op=dist.ReduceOp.SUM, group=ctx.group), grad, ctx.group)
        ep_input_grad_all_reduce.launches += 1
        return grad, None


def ep_all_reduce(local, group):
    """The experts' masked shares (T, d) summed over the expert group,
    one all-reduce; the backward keeps the cotangent (no collective)."""
    return _ExpertSum.apply(local, group)


def ep_input_grad_all_reduce(x, group):
    """``x`` as the experts' input: in the backward its partial
    gradients are summed over the expert group (one all-reduce, counted
    here when it runs)."""
    return _ExpertInput.apply(x, group)


def p2p_exchange(sends, dst, likes, src, group):
    """One neighbour exchange: the tensors ``sends`` go to global rank
    ``dst``, and tensors shaped like ``likes`` come from global rank
    ``src`` (either side may be None).  Every send and receive is posted
    before any is waited on, so ranks that exchange at once cannot
    deadlock.  gloo carries CPU tensors only: under gloo a card tensor
    goes through a host copy each way.  Returns the received tensors on
    the devices of ``likes`` (None when nothing is received)."""
    if not sends and not likes:
        return None
    staged = dist.get_backend(group) == "gloo"
    out = [(t.detach().to("cpu") if staged else t.detach()).contiguous()
           for t in sends or ()]
    got = [torch.empty(t.shape, dtype=t.dtype,
                       device="cpu" if staged else t.device)
           for t in likes or ()]
    reqs = ([dist.isend(t, dst, group=group, tag=i)
             for i, t in enumerate(out)]
            + [dist.irecv(t, src, group=group, tag=i)
               for i, t in enumerate(got)])
    for req in reqs:
        req.wait()
    p2p_exchange.launches += 1
    if not likes:
        return None
    return [t.to(like.device) for t, like in zip(got, likes)]


def stage_output_all_reduce(outs, group):
    """The pipeline's outputs summed over the stage group in place: the
    last stage's, with zeros from the others."""
    _collective(lambda: dist.all_reduce(outs, op=dist.ReduceOp.SUM,
                                        group=group), outs, group)
    stage_output_all_reduce.launches += 1


def stage_input_grad_all_reduce(dx, group):
    """The pipeline's input gradient summed over the stage group in
    place: stage 0's, with zeros from the others."""
    _collective(lambda: dist.all_reduce(dx, op=dist.ReduceOp.SUM,
                                        group=group), dx, group)
    stage_input_grad_all_reduce.launches += 1


def ring_all_gather(block, group, parts, dim):
    """Ring attention's output blocks gathered over ``group`` (``parts``
    ranks) and joined along ``dim``."""
    out = [torch.empty_like(block) for _ in range(parts)]
    _collective(lambda: dist.all_gather(out, block.contiguous(),
                                        group=group), block, group)
    ring_all_gather.launches += 1
    return torch.cat(out, dim=dim)


def ring_input_grad_all_reduce(grad, group):
    """Ring attention's zero-padded input-gradient blocks summed over
    ``group`` in place."""
    _collective(lambda: dist.all_reduce(grad, op=dist.ReduceOp.SUM,
                                        group=group), grad, group)
    ring_input_grad_all_reduce.launches += 1


#: the counted collectives (each adds one to its ``launches`` a call; a
#: captured step adds its collectives per replay, as the kernels do)
COUNTED = (grad_all_reduce, metric_all_reduce, tp_all_gather,
           tp_input_grad_all_reduce, ep_all_reduce,
           ep_input_grad_all_reduce, p2p_exchange, stage_output_all_reduce,
           stage_input_grad_all_reduce, ring_all_gather,
           ring_input_grad_all_reduce)


def reset_collective_counts():
    for fn in COUNTED:
        fn.launches = 0


def collective_counts():
    return {fn.__name__: fn.launches for fn in COUNTED}


reset_collective_counts()


# ------------------------------------------------------------------- join
def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, device=None):
    """Join the run: ``(process_index, process_count, backend)``.

    ``coordinator_address`` is ``host:port`` of rank 0's TCP store; all
    three values are required (no cluster environment is read).  Rank r
    runs on ``cuda:(r % device_count)`` unless ``device`` says ``cpu``;
    with no card and no ``device`` it raises.  Backend: ``nccl`` when
    every rank has a card of its own, ``gloo`` when ranks share a card
    or run on the CPU.  A process that has joined already returns its
    run (the same rank and size, or it raises)."""
    from veles_tpu_torch.device import resolve_device
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "a distributed run needs --coordinator-address HOST:PORT, "
            "--num-processes and --process-id (no cluster environment "
            "is read)")
    world, rank = int(num_processes), int(process_id)
    if not 0 <= rank < world:
        raise ValueError("process id %d outside a run of %d processes"
                         % (rank, world))
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world, rank):
            raise RuntimeError(
                "this process already joined a run as %d/%d, not %d/%d"
                % (dist.get_rank(), dist.get_world_size(), rank, world))
        return rank, world, dist.get_backend()
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, rank == 0,
                          timeout=TIMEOUT)
    store.set("veles_tpu_torch/place/%d" % rank,
              "%s/%s" % (socket.gethostname(), dev))
    places = [store.get("veles_tpu_torch/place/%d" % r).decode()
              for r in range(world)]
    own_card = dev.type == "cuda" and len(set(places)) == world
    backend = "nccl" if own_card else "gloo"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT, **kwargs)
    _JOINED.update(device=dev, backend=backend)
    _log.info("joined as process %d/%d on %s, backend %s (%s)", rank,
              world, dev, backend, "every rank has a card of its own"
              if own_card else "ranks share a card" if dev.type == "cuda"
              else "the CPU")
    return rank, world, backend


def shutdown():
    """Leave the run (destroys every process group of this process)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _JOINED.clear()


class _Log(Logger):
    pass


_log = _Log()


# ------------------------------------------------------------------- mesh
class Mesh:
    """Ranks laid out on named axes: ``devices`` is the grid of process
    indices (one rank a process), ``process_index`` this process's.  A
    mesh from :func:`make_mesh` also carries this rank's coordinates,
    its device, the backend and the process groups of its row (model)
    and column (data), and a gloo group for host-side checks."""

    def __init__(self, devices, axis_names=("data", "model"),
                 process_index=0, device=None, backend=None,
                 data_group=None, model_group=None, guard_group=None):
        self.devices = numpy.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.process_index = int(process_index)
        self.device = device
        self.backend = backend
        self.data_group = data_group
        self.model_group = model_group
        self.guard_group = guard_group
        where = numpy.argwhere(self.devices == self.process_index)
        #: this rank's coordinate on each axis (empty outside the mesh)
        self.coords = (dict(zip(self.axis_names,
                                (int(c) for c in where[0])))
                       if len(where) == 1 else {})
        self.data_index = self.coords.get("data")
        self.model_index = self.coords.get("model")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def index(self, axis):
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def group(self, axis):
        """The process group of this rank's line along ``axis``: the
        column (``data_group``) along the first axis, the row
        (``model_group``) along the second."""
        return (self.data_group, self.model_group)[
            self.axis_names.index(axis)]

    @property
    def size(self):
        return int(self.devices.size)


def _group(ranks, world):
    ranks = [int(r) for r in ranks]
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(n_devices=None, model_parallel=1,
              axis_names=("data", "model")):
    """The joined run's first ``n_devices`` ranks (default: all) as a
    (data, model) grid with ``model_parallel`` ranks a row, and its
    process groups (every rank of the run must call this, in the same
    order).  ``axis_names`` names the two axes: ``("data", "expert")``
    is the expert-parallel layout, ``model_parallel`` ranks a row."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a joined run: call "
                           "initialize_multihost first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    if n > world:
        raise ValueError("requested %d devices, have %d" % (n, world))
    if n % model_parallel:
        raise ValueError("n_devices %d not divisible by model_parallel %d"
                         % (n, model_parallel))
    grid = numpy.arange(n).reshape(n // model_parallel, model_parallel)
    data_group = model_group = None
    for col in grid.T:
        group = _group(col, world)
        if rank in col:
            data_group = group
    for row in grid:
        group = _group(row, world)
        if rank in row:
            model_group = group
    backend = dist.get_backend()
    guard = (dist.group.WORLD if backend == "gloo"
             else dist.new_group(list(range(world)), backend="gloo"))
    device = _JOINED.get("device")
    if device is None and backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(grid, axis_names, rank, device, backend, data_group,
                model_group, guard)


def model_shard_candidates(runner, min_width=1024):
    """Layer indices whose output width makes model-axis sharding pay
    (e.g. AlexNet's 4096-wide FC trunk).  Narrow layers stay replicated —
    a sharded 10-wide softmax costs more in collectives than it saves."""
    return [i for i, entry in enumerate(runner.state)
            if entry and entry["w"].shape[-1] >= min_width]


def spmd_loader_shard(mesh):
    """(shard_index, shard_count) for ``Loader.shard_spmd`` from the mesh
    layout: processes whose ranks cover the same block of data
    coordinates (different model columns of the same rows) load the
    same rows; on the standard layout (one rank a process) each data
    row is its own shard."""
    if "data" not in mesh.axis_names:
        raise ValueError("mesh has no 'data' axis (axes: %r)"
                         % (mesh.axis_names,))
    grid = numpy.moveaxis(mesh.devices, mesh.axis_names.index("data"), 0)
    grid = grid.reshape(grid.shape[0], -1)
    rows_of = {}
    for p in {int(d) for d in grid.flat}:
        rows_of[p] = tuple(sorted({r for r in range(grid.shape[0])
                                   if any(int(d) == p for d in grid[r])}))
    blocks = sorted(set(rows_of.values()), key=lambda t: t[0])
    flat = [r for b in blocks for r in b]
    if flat != list(range(grid.shape[0])) or \
            len({len(b) for b in blocks}) != 1:
        raise ValueError(
            "mesh data-axis layout is not a contiguous equal partition "
            "across processes (blocks: %r) — deterministic loader "
            "sharding needs one; reorder the device grid" % (blocks,))
    return blocks.index(rows_of[mesh.process_index]), len(blocks)


# ----------------------------------------------------------------- trainer
def _splittable(fwd):
    """True for the layers whose output columns are computed
    independently: dense layers with an elementwise activation and
    convolutions (not the transposed ones, not skip edges)."""
    from veles_tpu_torch.ops.conv import ConvBase
    from veles_tpu_torch.ops.deconv import DeconvBase
    from veles_tpu_torch.ops.nn_units import ForwardBase
    if getattr(fwd, "HAS_SKIP_EDGE", False) or fwd.ACTIVATION == "softmax":
        return False
    if isinstance(fwd, ConvBase):
        return not isinstance(fwd, DeconvBase)
    return isinstance(fwd, ForwardBase)


class ShardedTrainer(Logger):
    """Runs a FusedRunner's steps data- and tensor-parallel over a mesh.

    ``state`` is this rank's: replicated layers whole, the layers of
    ``model_shard_layers`` as this model rank's column slices.  The
    per-step entries take this rank's LOCAL rows (what a loader sharded
    with ``shard_spmd(*spmd_loader_shard(mesh))`` yields; ranks of one
    data row pass the same rows) and the GLOBAL live batch size; the
    epoch entries take the GLOBAL dataset and plan, identical on every
    rank, and slice the plan's minibatch columns by data rank.  The
    runner runs sharded from here on (``runner.shard``)."""

    def __init__(self, runner, mesh, model_shard_layers=()):
        if mesh.data_index is None:
            raise ValueError("process %d is outside the mesh"
                             % mesh.process_index)
        self.runner = runner
        self.mesh = mesh
        #: True when the mesh spans several processes
        self.multiprocess = mesh.size > 1
        self.data_parts = mesh.shape["data"]
        self.model_parts = mesh.shape["model"]
        #: layer index -> this rank's output columns (lo, hi)
        self.split = {}
        for i in sorted({int(i) for i in model_shard_layers}):
            entry = runner.state[i]
            if not entry or not _splittable(runner.forwards[i]):
                raise ValueError(
                    "layer %d (%s) cannot be split over the model axis: "
                    "only dense layers with an elementwise activation "
                    "and convolutions compute their output columns "
                    "independently" % (i, runner.forwards[i].name))
            n = entry["w"].shape[-1]
            if n % self.model_parts:
                raise ValueError("layer %d: %d output columns not "
                                 "divisible by model_parallel %d"
                                 % (i, n, self.model_parts))
            lo = mesh.model_index * (n // self.model_parts)
            self.split[i] = (lo, lo + n // self.model_parts)
        if self.multiprocess:
            self._assert_equal(
                self._leaves(runner.state),
                "initial runner state differs across processes — every "
                "process must build bit-identical params (same seed, "
                "pinned PRNG streams) before ShardedTrainer assembles "
                "shards from local copies")
        self.state = self._local(runner.state)
        #: global train-step counter (lr policies); see train_step
        self.step_count = 0
        self._data = self._labels = None
        self._programs = {}
        runner.shard = self

    # -------------------------------------------------------------- state
    @staticmethod
    def _leaves(state):
        return [v for entry in state for _, v in sorted(entry.items())]

    def _assert_equal(self, arrays, message):
        """Every process's crc32 digests of ``arrays`` must agree (an
        all-gather over the gloo guard group); else AssertionError."""
        mine = torch.tensor(
            [zlib.crc32(numpy.ascontiguousarray(
                a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else numpy.asarray(a)).tobytes()) for a in arrays],
            dtype=torch.int64)
        world = dist.get_world_size(self.mesh.guard_group)
        every = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(every, mine, group=self.mesh.guard_group)
        if any(not torch.equal(d, mine) for d in every):
            raise AssertionError(message)

    def _local(self, state):
        """This rank's share of a full state: the split layers' column
        slices (copies), the rest as they are."""
        out = []
        for i, entry in enumerate(state):
            cols = self.split.get(i)
            out.append(dict(entry) if cols is None else
                       {k: v[..., cols[0]:cols[1]].contiguous()
                        for k, v in entry.items()})
        return out

    def reload_from_runner(self):
        """This rank's state from the runner's (after a restore rewrote
        the unit Vectors and the runner), digest-guarded across
        processes."""
        if self.multiprocess:
            self._assert_equal(
                self._leaves(self.runner.state),
                "restored runner state differs across processes — every "
                "process must restore the same snapshot")
        self.state = self._local(self.runner.state)

    def sync_to_runner(self):
        """Gather the split layers' slices back into the runner's full
        state and write it to the unit Vectors (snapshots); every rank
        of the model group must call it."""
        full = []
        for i, entry in enumerate(self.state):
            if i not in self.split:
                full.append(dict(entry))
                continue
            full.append({k: self._gather_state(v) for k, v in entry.items()})
        self.runner.state = full
        self.runner.sync_to_units()

    def _gather_state(self, v):
        parts = [torch.empty_like(v) for _ in range(self.model_parts)]
        v = v.contiguous()
        group = self.mesh.model_group
        _collective(lambda: dist.all_gather(parts, v, group=group), v,
                    group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def fetch(tree):
        """Host values (numpy) of metrics: a dict, list or tensor."""
        if isinstance(tree, dict):
            return {k: ShardedTrainer.fetch(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(ShardedTrainer.fetch(v) for v in tree)
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu().numpy()
        return numpy.asarray(tree)

    # ------------------------------------------------- runner hooks
    def layer_rngs(self, rngs):
        """Each stochastic layer's key as this data rank's
        ``RowShard`` (the identity on a one-row data axis)."""
        if self.data_parts == 1:
            return rngs
        from veles_tpu_torch.ops import functional as F
        return [k if k is None or isinstance(k, F.CropDraws)
                else F.RowShard((k, self.mesh.data_index, self.data_parts))
                for k in rngs]

    def tp_forward(self, i, fwd, x, entry, rng, train):
        """Split layer ``i``'s forward: the local product, gathered to
        the full width along the last axis."""
        from veles_tpu_torch.ops import functional as F
        group, parts = self.mesh.model_group, self.model_parts
        if entry["w"].dim() == 2:
            y = F.dense_forward(x, entry["w"], entry.get("b"),
                                fwd.ACTIVATION)
            y = tp_all_gather(y.contiguous(), group, parts)
            return y.reshape((x.shape[0],)
                             + tuple(fwd.output_sample_shape)), None
        y, saved = fwd.apply_fused(x, entry, rng, train)
        return tp_all_gather(y.contiguous(), group, parts), saved

    def tp_backward(self, i, gd, x, y, err, entry, rng, saved):
        """Split layer ``i``'s backward: the weight gradient of the
        rank's slice of the error, the partial input gradient summed
        over the model group."""
        lo, hi = self.split[i]
        if entry["w"].dim() == 2:
            y = y.reshape(y.shape[0], -1)[:, lo:hi]
            err = err.reshape(err.shape[0], -1)[:, lo:hi]
        else:
            y, err = y[..., lo:hi], err.reshape(y.shape)[..., lo:hi]
        err_in, grads = gd.backward_fused(x, y.contiguous(),
                                          err.contiguous(), entry, rng,
                                          saved)
        if err_in is not None:
            tp_input_grad_all_reduce(err_in, self.mesh.model_group)
        return err_in, grads

    def reduce(self, all_grads, metrics):
        """One train step's gradient sums and metric sums over the data
        group: one flat bucket ``all_reduce`` (the ``*_max`` metrics a
        ``MAX``).  Each gradient's slot starts 16-byte aligned, so the
        fused SGD kernel reads it with 16-byte accesses."""
        sums = [k for k in metrics if not k.endswith("_max")]
        slots, at = [], 0
        for entry in all_grads:
            for g in entry or ():
                if g is not None:
                    slots.append((g, at))
                    at += -(-g.numel() // 4) * 4
        tail = [metrics[k].reshape(-1).to(torch.float32) for k in sums]
        bucket = torch.zeros(at + sum(t.numel() for t in tail),
                             dtype=torch.float32, device=self.device)
        for g, start in slots:
            bucket[start:start + g.numel()].copy_(g.reshape(-1))
        if tail:
            bucket[at:].copy_(torch.cat(tail))
        grad_all_reduce(bucket, self.mesh.data_group)
        views = iter([bucket[start:start + g.numel()].view(g.shape)
                      for g, start in slots])
        out = [None if entry is None else
               tuple(None if g is None else next(views) for g in entry)
               for entry in all_grads]
        return out, self._split_metrics(metrics, sums, bucket[at:])

    def reduce_metrics(self, metrics):
        """An eval step's metric sums over the data group."""
        sums = [k for k in metrics if not k.endswith("_max")]
        bucket = torch.cat([metrics[k].reshape(-1).to(torch.float32)
                            for k in sums])
        metric_all_reduce(bucket, self.mesh.data_group)
        return self._split_metrics(metrics, sums, bucket)

    def _split_metrics(self, metrics, sums, bucket):
        out, at = {}, 0
        for k in sums:
            v = metrics[k]
            out[k] = bucket[at:at + v.numel()].view(v.shape).to(v.dtype)
            at += v.numel()
        maxes = [k for k in metrics if k.endswith("_max")]
        if maxes:
            top = torch.stack([metrics[k].to(torch.float32).reshape(())
                               for k in maxes])
            metric_all_reduce(top, self.mesh.data_group, dist.ReduceOp.MAX)
            for j, k in enumerate(maxes):
                out[k] = top[j].to(metrics[k].dtype)
        return out

    # ------------------------------------------------------ per step
    @property
    def device(self):
        return next(v for e in self.state for v in e.values()).device

    def local_rows(self, a):
        """This data rank's contiguous rows of a GLOBAL batch (numpy or
        tensor)."""
        n = a.shape[0] // self.data_parts
        return a[self.mesh.data_index * n:(self.mesh.data_index + 1) * n]

    def put_batch(self, x, labels, mask):
        """This rank's rows as tensors on its device (x and the mask
        float32, labels as given: int32 classes or a regression
        target)."""
        dev = self.device

        def put(a, dtype=None):
            t = torch.as_tensor(numpy.asarray(a) if not isinstance(
                a, torch.Tensor) else a)
            return t.to(dev, dtype) if dtype is not None else t.to(dev)

        return put(x, torch.float32), put(labels), put(mask, torch.float32)

    def train_step(self, x, labels, mask, batch_size, rng=None, step=None):
        """One data/tensor-parallel train step on this rank's rows;
        ``batch_size`` is the GLOBAL live count, ``step`` defaults to an
        internal counter so lr policies decay as under FusedStep."""
        if rng is None and self.runner._has_stochastic:
            from veles_tpu_torch import prng
            rng = prng.get("dropout").key()
        if step is None:
            step = self.step_count
        self.state, metrics = self.train_step_pending(
            x, labels, mask, batch_size, rng, step)
        self.step_count = int(step) + 1
        return metrics

    def train_step_pending(self, x, labels, mask, batch_size, rng=None,
                           step=0):
        """(new state, metrics) of one train step without committing it
        (FusedStep's pending update, adopted by FusedCommit)."""
        x, labels, mask = self.put_batch(x, labels, mask)
        runner = self.runner
        return runner._step(self.state, x, labels, mask,
                            runner.host_operands(batch_size, step, rng))

    def eval_step(self, x, labels, mask):
        x, labels, mask = self.put_batch(x, labels, mask)
        return self.runner._eval_step(self.state, x, labels, mask)

    # ------------------------------------------------- epoch scan
    # GLOBAL-plan API: every process passes the SAME full dataset and the
    # SAME (B, mb) plan (cross-checked by digest across processes); each
    # rank trains on its columns of the plan.
    def place_dataset(self, data, labels=None):
        """Put the full GLOBAL dataset on this rank's device for the
        epoch entries (labels None for AE targets); every process must
        pass identical arrays (digest-checked)."""
        if self.multiprocess:
            self._assert_equal(
                [data] + ([labels] if labels is not None else []),
                "place_dataset arrays differ across processes — the "
                "epoch-scan path needs the identical GLOBAL dataset "
                "everywhere")
        dev = self.device
        self._data = torch.as_tensor(
            data if isinstance(data, torch.Tensor)
            else numpy.asarray(data)).to(dev, torch.float32)
        self._labels = (None if labels is None else torch.as_tensor(
            labels if isinstance(labels, torch.Tensor)
            else numpy.asarray(labels)).to(dev))
        self._programs = {}

    def _place_plan(self, idx, mask, rng=None):
        """Validate a (…, mb) plan, cross-check it (and the key) across
        processes, and return this rank's columns (idx, mask)."""
        if self._data is None:
            raise ValueError("call place_dataset(data, labels) first")
        idx, mask = numpy.asarray(idx), numpy.asarray(mask)
        if idx.shape[-1] % self.data_parts:
            raise ValueError(
                "minibatch size %d not divisible by data-axis size %d"
                % (idx.shape[-1], self.data_parts))
        if self.multiprocess:
            self._assert_equal(
                [idx, mask] + ([numpy.asarray(rng)] if rng is not None
                               else []),
                "epoch-scan plan/rng differs across processes — build "
                "the plan from an UNsharded loader (global plan, not "
                "shard_spmd) and derive the rng from the shared seed")
        return self.local_columns(idx), self.local_columns(mask)

    def local_columns(self, a):
        """This data rank's minibatch columns of a plan (…, mb)."""
        n = a.shape[-1] // self.data_parts
        r = self.mesh.data_index
        return a[..., r * n:(r + 1) * n]

    def require_epoch_rng(self, rng):
        if self.runner._has_stochastic and rng is None:
            raise ValueError(
                "this network has stochastic layers (dropout): pass "
                "rng=prng.PRNGKey(...) to train_epoch")

    def _program(self, rows, group, groups, eval_rows, mb):
        """A ScanProgram over the placed dataset (one per geometry),
        holding this rank's current state."""
        from veles_tpu_torch.compiled import ScanProgram
        key = (rows, group, groups, tuple(sorted(eval_rows.items())), mb)
        program = self._programs.get(key)
        if program is None:
            program = self._programs[key] = ScanProgram(
                self.runner, self.device, [self._data], [self._labels],
                rows, mb, group, groups, eval_rows, state=self.state)
        else:
            program.set_state(self.state)
        return program

    def _chunk(self, idx, mask, rng, step0, evals=(), eval_first=False,
               fold_epochs=True):
        """``k`` epochs of (k, B, mb) plans (and per epoch the eval sets
        ``evals``: (name, idx, mask)) through the captured step: (new
        state, train totals stacked (k rows), {name: eval totals
        stacked})."""
        from veles_tpu_torch import prng
        runner = self.runner
        idx, mask = numpy.asarray(idx), numpy.asarray(mask)
        k, steps = idx.shape[0], idx.shape[1]
        if steps:
            self.require_epoch_rng(rng)
        lidx, lmask = self._place_plan(idx, mask, rng)
        placed = [(name,) + self._place_plan(eidx, emask)
                  for name, eidx, emask in evals]
        if step0 is None:
            step0 = self.step_count
        program = self._program(k * steps, steps, k,
                                {n: len(e) for n, e, _ in placed},
                                lidx.shape[-1])
        for name, eidx, emask in placed:
            program.evals[name].load(numpy.tile(eidx, (k, 1)),
                                     numpy.tile(emask, (k, 1)))
        ops = []
        for e in range(k):
            off = int(step0) + e * steps
            key = rng
            if rng is not None and fold_epochs:
                key = prng.fold_in(rng, off)
            for s in range(steps):
                ops.append(runner.host_operands(
                    int(mask[e, s].sum()), off + s,
                    None if key is None else prng.fold_in(key, s)))
        if steps:
            program.train.load(lidx.reshape(k * steps, -1),
                               lmask.reshape(k * steps, -1),
                               program.operand_tables(ops))
        program.train.reset()
        for tab in program.evals.values():
            tab.reset()
        for _ in range(k):
            if eval_first:
                self._replay_evals(program, placed)
            for _ in range(steps):
                program.replay_train()
            if not eval_first:
                self._replay_evals(program, placed)
        train = (_stack([program.train.group_totals(e) for e in range(k)])
                 if steps else {})
        out = {name: _stack([program.evals[name].group_totals(e)
                             for e in range(k)]) for name, _, _ in placed}
        state = [{key: v.clone() for key, v in e.items()}
                 for e in program.state]
        return state, train, out

    @staticmethod
    def _replay_evals(program, placed):
        for name, eidx, _ in placed:
            for _ in range(len(eidx)):
                program.replay_eval(name)

    def train_epoch(self, idx, mask, rng=None, step0=None):
        """One epoch of a (B, mb) plan (step s takes ``fold_in(rng, s)``
        and global step ``step0 + s``); returns the epoch's metric
        totals (host)."""
        if step0 is None:
            step0 = self.step_count
        self.state, train, _ = self._chunk(
            numpy.asarray(idx)[None], numpy.asarray(mask)[None], rng,
            step0, fold_epochs=False)
        self.step_count = int(step0) + numpy.asarray(idx).shape[0]
        return {k: v[0] for k, v in train.items()}

    def train_epochs(self, idx, mask, rng=None, step0=None):
        """``k`` epochs of (k, B, mb) plans (epoch e's key
        ``fold_in(rng, step0 + e·B)``); the per-epoch totals stacked."""
        idx = numpy.asarray(idx)
        if idx.ndim != 3:
            raise ValueError("train_epochs wants (k, B, mb) per-epoch "
                             "plans; use train_epoch for a single epoch")
        if step0 is None:
            step0 = self.step_count
        self.state, train, _ = self._chunk(idx, mask, rng, step0)
        self.step_count = int(step0) + idx.shape[0] * idx.shape[1]
        return train

    def train_epochs_eval(self, idx, mask, vidx, vmask, rng=None,
                          step0=None, eval_first=False):
        """``k`` (train epoch + validation) rounds: (train totals
        stacked, validation totals stacked)."""
        idx = numpy.asarray(idx)
        if idx.ndim != 3:
            raise ValueError("train_epochs_eval wants (k, B, mb) "
                             "per-epoch plans")
        if step0 is None:
            step0 = self.step_count
        self.state, train, evals = self._chunk(
            idx, mask, rng, step0, [("validation", vidx, vmask)],
            eval_first)
        self.step_count = int(step0) + idx.shape[0] * idx.shape[1]
        return train, evals["validation"]

    def chunk_eval_pending(self, idx, mask, vidx, vmask, rng=None,
                           step0=None, eval_first=False, tidx=None,
                           tmask=None):
        """:meth:`train_epochs_eval` with an optional test set, not
        committed: (new state, train stacked, validation stacked, test
        stacked or None); adopt with ``self.state = new_state``."""
        idx = numpy.asarray(idx)
        if idx.ndim != 3:
            raise ValueError("chunk_eval_pending wants (k, B, mb) "
                             "per-epoch plans")
        evals = ([("test", tidx, tmask)] if tidx is not None else []) + [
            ("validation", vidx, vmask)]
        state, train, out = self._chunk(idx, mask, rng, step0, evals,
                                        eval_first)
        return state, train, out["validation"], out.get("test")

    def eval_epoch(self, idx, mask):
        """Whole-set evaluation of a (B, mb) plan: the metric totals."""
        idx = numpy.asarray(idx)
        empty = numpy.zeros((1, 0, idx.shape[-1]), idx.dtype)
        _, _, out = self._chunk(empty, empty.astype(numpy.float32), None,
                                self.step_count, [("eval", idx, mask)])
        return {k: v[0] for k, v in out["eval"].items()}


def _stack(rows):
    """A list of host metric dicts as one dict of stacked arrays."""
    return {k: numpy.stack([numpy.asarray(r[k]) for r in rows])
            for k in rows[0]} if rows else {}
