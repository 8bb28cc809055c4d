"""Multi-host process-group formation and the lockstep learner (counterpart
of ``twtml_tpu/parallel/distributed.py``).

The reference runs one model on a Spark cluster (``--master
spark://host:port``); the JAX package forms a ``jax.distributed`` group;
the port forms ``torch.distributed`` process groups as explicit objects
(never the default group), so that an elastic run (parallel/elastic.py)
can form a new one each epoch and abandon the old. Joining has two halves:
``setup`` chooses this process's device once, ``cuda:(launch id % device
count)`` (every rank of a one-card machine on ``cuda:0``); ``form`` builds
one epoch's group over a ``TCPStore``. ``initialize`` is both for a
lockstep run: a store at the coordinator's host:port, hosted by rank 0.

The collective backend follows one rule, decided from what every rank
publishes in the store before the group forms: ``nccl`` when every rank on
a host has a card of its own, ``gloo`` otherwise (ranks that share a card,
or ``--backend cpu``). NCCL refuses two ranks on one card, so a one-card
machine runs its ranks over gloo; the math stays on the card either way,
and gloo's reductions of card tensors go through one page-locked host
buffer (``Collectives.allreduce_``, its copies counted). No other backend
is tried when the chosen one fails to form. The host-side agreements (the
lockstep tick, the alignment of the wire, the checkpoint broadcast) run on
a gloo group over CPU tensors whatever the data backend.

``MultiHostSGDModel`` is the learner the apps drive across hosts: this
rank's batch in, the step's all-reduces inside, global scalar stats and
this rank's predictions out (parallel/sharding.py ``ParallelSGDModel`` is
the rank-local model it wraps). Every rank packs its rows as its segment of
the shard-segment wire, at a units bucket (and codec bucket) the ranks
agree by ONE all-gather a batch.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import time

import numpy as np
import torch

from ..features.batch import RaggedUnitBatch, UnitBatch
from ..telemetry import metrics as _metrics
from ..utils import get_logger
from .mesh import DataMesh, make_mesh

log = get_logger("parallel.distributed")

# a group that has not formed within this many seconds is a failure
STORE_TIMEOUT_S = 120.0
# a collective inside a step waits for its peers at most the lockstep
# watchdog's bound (streaming/context.py), but never less than this: the
# ranks of a group start (and first build the kernels) at their own pace
MIN_COLLECTIVE_TIMEOUT_S = 30.0

# host-side collective calls, by kind (tests and chip_smoke count them: a
# lockstep tick adds exactly one cadence all-gather, a dispatched batch of
# the ragged wire one alignment all-gather)
COUNTERS = {
    "cadence_allgathers": 0, "align_allgathers": 0, "broadcasts": 0,
    "allreduces": 0, "row_allgathers": 0, "staged_copies": 0,
}
# host seconds spent in them (the all-reduces with their staging copies and
# the wait for the card; the cadence all-gathers with the wait for the peers)
SECONDS = {"allreduce": 0.0, "cadence_allgather": 0.0}

_STATE: dict = {"mesh": None, "backend": None, "group": None, "host_group": None,
                "device": None, "lead_rank": 0}


def choose_backend(device_type: str, hosts: "list[tuple[str, int]]") -> str:
    """The collective backend of a group whose rank r runs on host
    ``hosts[r][0]`` with ``hosts[r][1]`` cards: ``nccl`` when the ranks run
    on cards and no host has more ranks than cards, else ``gloo``."""
    if device_type != "cuda":
        return "gloo"
    ranks: dict = {}
    cards: dict = {}
    for host, n in hosts:
        ranks[host] = ranks.get(host, 0) + 1
        cards[host] = n
    return "nccl" if all(ranks[h] <= cards[h] for h in ranks) else "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % device count)``, or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("--backend cuda: this rank sees no CUDA device (use --backend cpu "
                           "for a CPU group)")
    return torch.device("cuda", rank % count)


def setup(process_id: int, device_type: str = "cuda") -> torch.device:
    """The one-time half of joining: this process's device,
    ``rank_device(process_id)``, chosen and made current before any group
    forms, and kept for the process's life (an elastic group re-forms over
    the same device; ``process_id`` is the launch id)."""
    device = rank_device(process_id, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _STATE["device"] = device
    return device


def _process_group(backend: str, store, rank: int, size: int,
                   timeout: datetime.timedelta):
    """One explicit process group over ``store`` (never the default group:
    an elastic epoch forms a new one and abandons the old without a
    shutdown barrier)."""
    import torch.distributed as dist

    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    return dist.ProcessGroupGloo(store, rank, size, timeout)


def form(store, process_id: int, num_processes: int, timeout: datetime.timedelta,
         lead_rank: int = 0) -> str:
    """The per-epoch half: every rank publishes its host and card count in
    ``store``, the backend follows ``choose_backend`` (taken anew each
    epoch), and the group forms as explicit process groups over the store:
    the data group, and a gloo host group for the agreements when the data
    group is nccl. ``lead_rank`` is the rank whose object a broadcast
    sends. Logs the backend and sets the ``distributed.nccl`` gauge (1
    nccl, 0 gloo). Returns the backend."""
    import torch.distributed as dist

    device = _STATE["device"]
    if device is None:
        raise RuntimeError("distributed.setup must choose the device before a group forms")
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    store.set(f"twtml/host/{process_id}", f"{socket.gethostname()}|{cards}")
    hosts = []
    for r in range(num_processes):
        name, _, n = store.get(f"twtml/host/{r}").decode().rpartition("|")
        hosts.append((name, int(n)))
    backend = choose_backend(device.type, hosts)
    group = _process_group(backend, dist.PrefixStore("data/", store), process_id,
                           num_processes, timeout)
    host_group = group
    if backend != "gloo":
        host_group = _process_group("gloo", dist.PrefixStore("host/", store), process_id,
                                    num_processes, timeout)
    _STATE.update(mesh=make_mesh(num_processes=num_processes, process_index=process_id),
                  backend=backend, group=group, host_group=host_group, store=store,
                  lead_rank=int(lead_rank))
    _metrics.get_registry().gauge("distributed.nccl").set(1 if backend == "nccl" else 0)
    log.info("joined process group: rank %d/%d on %s, collectives over %s",
             process_id, num_processes, device, backend)
    return backend


def initialize(coordinator: str, num_processes: int, process_id: int,
               device_type: str = "cuda") -> bool:
    """Join the group of ``num_processes`` ranks as rank ``process_id``
    through a ``TCPStore`` at ``coordinator`` (host:port; rank 0 hosts the
    store): ``setup`` then ``form``, the collectives timing out after
    ``collective_timeout()``. Returns whether this rank is the lead (rank
    0), which alone prints and publishes."""
    import torch.distributed as dist

    if _STATE["group"] is not None:
        raise RuntimeError("the process group is already formed")
    host, _, port = coordinator.rpartition(":")
    setup(process_id, device_type)
    timeout = datetime.timedelta(seconds=STORE_TIMEOUT_S)
    store = dist.TCPStore(host or "127.0.0.1", int(port), num_processes,
                          is_master=process_id == 0, timeout=timeout)
    form(store, process_id, num_processes, collective_timeout())
    return process_id == 0


def collective_timeout() -> datetime.timedelta:
    """How long a collective waits for its peers before it raises: the
    lockstep watchdog's bound (``TWTML_LOCKSTEP_TIMEOUT_S``, at least
    ``MIN_COLLECTIVE_TIMEOUT_S``), so a peer that dies inside a step (an
    all-reduce, where the cadence watchdog does not look) fails the
    survivor's batch within it, and the lockstep loop aborts, or, under
    ``--elastic on``, rescues; with the watchdog off, ``STORE_TIMEOUT_S``."""
    from ..streaming.context import LOCKSTEP_TIMEOUT_DEFAULT_S, LOCKSTEP_TIMEOUT_ENV

    watch = float(os.environ.get(LOCKSTEP_TIMEOUT_ENV, "") or LOCKSTEP_TIMEOUT_DEFAULT_S)
    seconds = max(watch, MIN_COLLECTIVE_TIMEOUT_S) if watch > 0 else STORE_TIMEOUT_S
    return datetime.timedelta(seconds=seconds)


def abandon() -> tuple:
    """Leave the current group WITHOUT shutting it down (a dead peer, or a
    thread still inside one of its collectives, can block a shutdown): the
    group's objects are returned for the caller to keep alive, and the
    module forgets them. The device stays."""
    kept = (_STATE.get("group"), _STATE.get("host_group"), _STATE.get("store"))
    _STATE.update(mesh=None, backend=None, group=None, host_group=None, store=None,
                  lead_rank=0)
    return kept


def shutdown() -> None:
    """Leave the group (a no-op when none formed): the module drops its
    process groups, which close their connections once nothing uses them.
    An abandoned group is never here (``abandon``), so nothing waits on a
    dead peer."""
    _STATE.update(mesh=None, backend=None, group=None, host_group=None, store=None,
                  device=None, lead_rank=0)


def mesh() -> DataMesh:
    """The group's data axis (one process when no group formed)."""
    return _STATE["mesh"] or DataMesh()


def is_multihost() -> bool:
    return mesh().num_processes > 1


def device() -> "torch.device | None":
    """This rank's device, once the group formed."""
    return _STATE["device"]


def host_allgather(arr: np.ndarray, kind: str = "cadence") -> np.ndarray:
    """Every rank's copy of the 1-D float64 ``arr``, as [ranks, n], over the
    current group's host (gloo) group: the lockstep agreements. One process
    (or a group of one): ``arr[None]``. Counted in
    ``COUNTERS[kind + "_allgathers"]``."""
    COUNTERS[f"{kind}_allgathers"] += 1
    arr = np.ascontiguousarray(arr, np.float64).reshape(-1)
    group = _STATE["host_group"]
    if group is None or mesh().num_processes <= 1:
        return arr[None]
    t0 = time.perf_counter()
    t = torch.from_numpy(arr)
    out = [torch.empty_like(t) for _ in range(mesh().num_processes)]
    group.allgather([out], [t]).wait()
    if kind == "cadence":
        SECONDS["cadence_allgather"] += time.perf_counter() - t0
    return torch.stack(out).numpy()


def broadcast_object(obj, is_source: bool):
    """The lead's ``obj`` on every rank (a checkpoint's meta and state, a
    rollback's verdict), over the current host group from the lead's rank
    (``form``'s ``lead_rank``); ``is_source`` on exactly one rank, the
    lead. One process (or a group of one): ``obj``."""
    COUNTERS["broadcasts"] += 1
    group = _STATE["host_group"]
    if group is None or mesh().num_processes <= 1:
        return obj
    root = _STATE["lead_rank"]
    payload = pickle.dumps(obj if is_source else None)
    size = torch.tensor([len(payload) if is_source else 0], dtype=torch.int64)
    group.broadcast([size], _broadcast_opts(root)).wait()
    data = (torch.frombuffer(bytearray(payload), dtype=torch.uint8) if is_source
            else torch.empty((int(size[0]),), dtype=torch.uint8))
    group.broadcast([data], _broadcast_opts(root)).wait()
    return pickle.loads(data.numpy().tobytes())


def _broadcast_opts(root: int):
    import torch.distributed as dist

    opts = dist.BroadcastOptions()
    opts.rootRank = int(root)
    opts.rootTensor = 0
    return opts


class Collectives:
    """The reductions a data-parallel step makes over the current group's
    ranks (``make_sgd_train_step(group=...)``): the JAX package's ``psum``
    and ``all_gather`` over the data axis. ``rank``/``world`` place this
    rank, ``group`` is the epoch's process group (None, and ``world`` 1,
    for a group of one: nothing is reduced and no all-reduce issued);
    ``staged`` routes card tensors through a page-locked host buffer (the
    gloo transport)."""

    def __init__(self, *, rank: int = 0, world: int = 1, staged: bool = True, group=None):
        self.rank = rank
        self.world = world
        self.staged = staged
        self.group = group
        self._pinned: dict = {}
        if world > 1 and group is None:
            raise ValueError(f"a data-parallel step over {world} ranks needs their group")

    @classmethod
    def from_group(cls) -> "Collectives":
        """The current group (``form``)."""
        m = mesh()
        return cls(rank=m.process_index, world=m.num_processes,
                   staged=_STATE["backend"] == "gloo",
                   group=_STATE["group"] if m.num_processes > 1 else None)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        key = (t.numel(), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty((t.numel(),), dtype=t.dtype,
                                                  pin_memory=True)
        return buf

    def allreduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM ``t`` over the ranks, in place (every rank gets the same
        bits). A card tensor over gloo: one copy to page-locked memory, a
        wait for it, the host all-reduce, one copy back queued on the
        stream. A group of one returns ``t`` as it is."""
        if self.world <= 1:
            return t
        COUNTERS["allreduces"] += 1
        t0 = time.perf_counter()
        try:
            return self._allreduce(t)
        finally:
            SECONDS["allreduce"] += time.perf_counter() - t0

    def _allreduce(self, t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda and self.staged:
            host = self._host(t)
            host.copy_(t.reshape(-1), non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            event.synchronize()
            self.group.allreduce([host]).wait()
            t.copy_(host.reshape(t.shape), non_blocking=True)
            COUNTERS["staged_copies"] += 2
            return t
        self.group.allreduce([t]).wait()
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's [B_local, ...] rows of ``t`` in rank order: [ranks ·
        B_local, ...] on ``t``'s device (a card tensor over gloo goes
        through the host)."""
        COUNTERS["row_allgathers"] += 1
        t = t.contiguous()
        if self.world <= 1:
            return t
        if t.is_cuda and not self.staged:
            out = torch.empty((self.world * t.shape[0],) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=t.device)
            self.group._allgather_base(out, t).wait()
            return out
        src = t.cpu()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        self.group.allgather([parts], [src]).wait()
        return torch.cat(parts).to(t.device)


# ---- the cross-host agreement of the shard-segment wire --------------------

def _as_units(batch: RaggedUnitBatch, dtype) -> RaggedUnitBatch:
    if batch.units.dtype == dtype:
        return batch
    return RaggedUnitBatch(np.asarray(batch.units, dtype), batch.offsets, batch.numeric,
                           batch.label, batch.mask, row_len=batch.row_len,
                           num_shards=batch.num_shards)


def ragged_local_aligned_codec(batch: RaggedUnitBatch,
                               codec: str = "") -> "tuple[RaggedUnitBatch, int]":
    """This rank's ragged batch aligned as its one shard segment (a rank
    holds one device) at the units bucket every rank agreed, and the agreed codec
    bucket (0: the wire ships raw), from ONE all-gather of (units needed,
    largest coded segment, uint8 units): the JAX package's rule, so the
    buffers are its bytes. Without a codec the wire is harmonized to
    uint16, as the JAX package ships the multi-host raw wire. The coded
    bucket bounds every rank's segments after re-alignment to the agreed
    raw bucket: growing a segment only lengthens its trailing zero run, and
    the greedy encode turns 2k zeros into k zero-pair codes plus at most
    one boundary byte."""
    from ..features.batch import align_ragged_shards, ragged_shard_bucket

    if not codec or codec == "off":
        batch = _as_units(batch, np.uint16)
        need = ragged_shard_bucket(batch, 1)
        agreed = int(host_allgather(np.array([need], np.float64), "align")[:, 0].max())
        return align_ragged_shards(batch, 1, unit_bucket=agreed), 0
    from ..features.wirecodec import encode, encoded_bucket

    need = ragged_shard_bucket(batch, 1)
    eligible = int(batch.units.dtype == np.uint8)
    enc_max = 0
    if eligible:
        local = align_ragged_shards(batch, 1, unit_bucket=need)
        enc_max = int(encode(np.asarray(local.units).reshape(-1)).shape[0])
    gathered = host_allgather(np.array([need, enc_max, eligible], np.float64),
                              "align").astype(np.int64)
    agreed_raw = int(gathered[:, 0].max())
    aligned = align_ragged_shards(batch, 1, unit_bucket=agreed_raw)
    if not bool(gathered[:, 2].min()):
        return _as_units(aligned, np.uint16), 0
    per_host = gathered[:, 1] + (agreed_raw - gathered[:, 0] + 1) // 2 + 1
    agreed_codec = encoded_bucket(int(per_host.max()))
    if agreed_codec >= agreed_raw:
        return aligned, 0
    return _as_units(aligned, np.uint8), agreed_codec


class MultiHostSGDModel:
    """The learner of a lockstep group (the JAX package's
    ``MultiHostSGDModel``): this rank's batch in and on this rank's device,
    the data-parallel step of ``inner`` (a ``ParallelSGDModel``) with its
    all-reduces, global scalar stats (identical on every rank) and this
    rank's predictions out. A ragged batch is packed as this rank's segment
    of the shard-segment wire at the buckets ``ragged_local_aligned_codec``
    agrees, ONE all-gather a batch and no other collective outside the
    step; ``prepare`` does that agreement for a ``--superBatch`` group's
    batches (recording the codec bucket), and ``pack_group_for_wire``
    combines the K recorded buckets with no collective. Only the lead
    (rank 0) prints and publishes."""

    accepts_packed = True

    def __init__(self, inner, mesh_: DataMesh, wire_codec: str = "", rebuilder=None):
        self.inner = inner
        self.mesh = mesh_
        self.num_data = mesh_.num_data
        self.wire_codec = wire_codec
        self._lead = mesh_.process_index == 0
        # codec buckets agreed at prepare(), by id of the aligned batch (held)
        self._group_buckets: dict = {}
        # elastic membership: how to build the rank-local model for a
        # re-formed epoch's mesh (apps/common.build_model sets it)
        self._rebuilder = rebuilder

    def rebuild(self, mesh_: DataMesh) -> "MultiHostSGDModel":
        """Swap in a fresh rank-local model for a NEW epoch's ``mesh_`` in
        place, so every holder of this wrapper (the fetch pipeline, the
        checkpoint's closures, the sentinel) keeps working across an
        elastic membership change; a group of one runs the split at one
        rank and issues no all-reduce. The weights start at zeros: the
        caller restores them from the lead's broadcast before the next
        tick."""
        if self._rebuilder is None:
            raise RuntimeError("MultiHostSGDModel.rebuild needs the rebuilder closure "
                               "(set by apps/common.build_model)")
        self.inner = self._rebuilder(mesh_)
        self.mesh = mesh_
        self.num_data = mesh_.num_data
        self._lead = mesh_.process_index == 0
        self._group_buckets.clear()
        return self

    # the rank-local model's surface, which the app runtime reads
    @property
    def device(self):
        return self.inner.device

    @property
    def route(self) -> str:
        return self.inner.route

    def bind_thread(self) -> None:
        self.inner.bind_thread()

    @property
    def latest_weights(self) -> np.ndarray:
        return self.inner.latest_weights

    def set_initial_weights(self, weights) -> "MultiHostSGDModel":
        self.inner.set_initial_weights(weights)
        return self

    def fetch_output(self, out):
        return self.inner.fetch_output(out)

    def _aligned(self, batch: RaggedUnitBatch) -> "tuple[RaggedUnitBatch, int]":
        got = self._group_buckets.pop(id(batch), None)
        if got is not None:  # agreed at prepare() (a partial group's tail)
            return got
        return ragged_local_aligned_codec(batch, self.wire_codec)

    def prepare(self, batch):
        """Agree a ragged batch's buckets before a superbatch groups it, so
        every rank's group signatures match; a padded units batch is
        harmonized to uint16. Runs at the lockstep tick, so the all-gather
        pairs on every rank."""
        if isinstance(batch, RaggedUnitBatch):
            aligned, bucket = ragged_local_aligned_codec(batch, self.wire_codec)
            self._group_buckets[id(aligned)] = (aligned, bucket)
            return aligned
        if isinstance(batch, UnitBatch) and batch.units.dtype != np.uint16:
            return batch._replace(units=batch.units.astype(np.uint16))
        return batch

    def pack_for_wire(self, batch):
        """This rank's segment of the group's shard-segment wire."""
        from ..features.batch import pack_ragged_sharded

        if not isinstance(batch, RaggedUnitBatch):
            raise TypeError("pack_for_wire is the ragged wire's pack")
        aligned, bucket = self._aligned(batch)
        return pack_ragged_sharded(aligned, num_shards_out=self.num_data,
                                   codec=self.wire_codec if bucket else None,
                                   codec_bucket=bucket or None)

    def pack_group_for_wire(self, batches):
        """A superbatch group of ``prepare``d batches as this rank's segment
        of the group wire: coded when every batch agreed a codec bucket (the
        largest), raw when one agreed raw: arithmetic on agreed values, no
        collective."""
        from ..features.batch import pack_ragged_group

        aligned, buckets = [], []
        for b in batches:
            got = self._group_buckets.pop(id(b), None)
            if got is None:
                got = ragged_local_aligned_codec(b, "")
            aligned.append(got[0])
            buckets.append(got[1])
        bucket = 0 if 0 in buckets or not self.wire_codec else max(buckets)
        if not bucket:
            aligned = [_as_units(b, np.uint16) for b in aligned]
        return pack_ragged_group(aligned, num_shards_out=self.num_data,
                                 codec=self.wire_codec if bucket else None,
                                 codec_bucket=bucket or None)

    def step(self, batch):
        """One data-parallel step on this rank's batch (a packed segment, a
        ragged batch, which is agreed and aligned first, or a padded one);
        returns the device StepOutput, nothing waited for."""
        if isinstance(batch, RaggedUnitBatch):
            batch = self._aligned(batch)[0]
        elif isinstance(batch, UnitBatch) and batch.units.dtype != np.uint16:
            batch = batch._replace(units=batch.units.astype(np.uint16))
        return self.inner.step(batch)

    def step_many(self, stacked):
        """K steps of a ``prepare``d group (a packed group or a stack). The
        superbatch dispatches a group as soon as it closes, so every bucket
        still recorded belongs to this group (a stack never pops them)."""
        self._group_buckets.clear()
        return self.inner.step_many(stacked)
