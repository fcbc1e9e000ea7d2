"""Device-mesh sharding of the consensus data plane (the port of
``etcd_tpu/parallel/mesh.py``).

Two mesh axes, as in the reference:

- ``g`` (groups): data-parallel.  Raft group state ([G, ...] tensors)
  and WAL record rows ([N, L]) split their leading axis here; every
  block steps its own slice of the groups, and the commit frontier is
  gathered (BASELINE config 5).
- ``s`` (sequence): the WAL byte dimension.  Each (g, s) block computes
  the raw CRC of its byte range, and the s-blocks combine by the
  linearity of the CRC over GF(2).

Torch has no ``Mesh``/``shard_map`` that one process can run over one
card, so the port spells the layout out:

- :class:`GroupMesh` is a ``(g, s)`` grid of ``torch.device``s.  It may
  repeat one device: several *virtual shards* on one card (or on the
  CPU), the counterpart of the virtual XLA devices the JAX package's
  tests run on.
- A *placed* ``[G, ...]`` value is the list of its g-blocks, block ``i``
  a contiguous copy on ``mesh.devices[i][0]``; a placed ``buf`` is the
  g x s grid (a list of g lists of s blocks) of contiguous copies, block
  ``(i, j)`` on ``mesh.devices[i][j]``; a placed ``GroupState`` holds a
  list of g-blocks in every field.  Scalars (the chain seed) stay Python
  ints.  Placement copies, so no step writes through to the caller.
- The three collectives are tensor ops between blocks, with no host
  sync: **psum over s** is the XOR of the s-blocks' raw CRC states, each
  shifted past the bytes to its right; **ppermute over g** hands block
  ``i`` the last stored CRC of block ``i - 1`` (block 0 takes the seed);
  **all_gather over g** concatenates the g-blocks onto the mesh's first
  device, where the host reads them (on one card, the gather's only
  copy).
- The reference's ``shard_map`` steps the ``GroupState``, which is
  replicated over ``s``, on every (i, j) device; the port steps each
  g-block once, on ``mesh.devices[i][0]``.

:class:`BlockLayout` is the same g-split as the engines hold it
(``MultiRaft.shard``, ``DistMember.shard``): per-block dispatch of the
engine's ops, host inputs split by block, host reads gathered first.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..ops.crc_device import (
    chain_links_device,
    chain_verify_device,
    raw_crc_batch,
    shift_crc_batch,
    u32_tensor,
)
from ..ops.quorum import maybe_commit_batch
from ..raft.batched import GroupState, replication_round

_MASK32 = 0xFFFFFFFF

#: Virtual devices of the CPU: the counterpart of the JAX package's
#: ``--xla_force_host_platform_device_count=8`` (tests/conftest.py).
VIRTUAL_CPU_DEVICES = 8


def local_devices(device=None) -> list[torch.device]:
    """The devices a mesh is built over when none are named: every CUDA
    device (``torch.cuda.device_count()``; raises without CUDA), or for
    ``device="cpu"`` :data:`VIRTUAL_CPU_DEVICES` virtual shards of the
    CPU."""
    dev = default_device(device)
    if dev.type == "cpu":
        return [dev] * VIRTUAL_CPU_DEVICES
    return [torch.device(dev.type, k)
            for k in range(torch.cuda.device_count())]


class GroupMesh:
    """A ``(g, s)`` grid of devices: ``devices[i][j]`` holds block
    ``(i, j)``.  ``shape`` and ``size`` read as the JAX mesh's do."""

    def __init__(self, devices):
        rows = [tuple(torch.device(d) for d in row) for row in devices]
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh needs a non-empty rectangular grid "
                             "of devices")
        self.devices = tuple(rows)

    @property
    def shape(self) -> dict:
        return {"g": len(self.devices), "s": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def home(self) -> torch.device:
        """The first device: where gathered values land."""
        return self.devices[0][0]

    def distinct_devices(self) -> list[torch.device]:
        seen: list[torch.device] = []
        for row in self.devices:
            for d in row:
                if d not in seen:
                    seen.append(d)
        return seen

    def layout(self, g: int) -> "BlockLayout":
        """The g-block layout of a ``[g]``-leading batch on this mesh."""
        check_group_divisible(self, g)
        return BlockLayout(g, [row[0] for row in self.devices])

    def __repr__(self) -> str:
        return (f"GroupMesh(g={self.shape['g']}, s={self.shape['s']}, "
                f"devices={[str(d) for d in self.distinct_devices()]})")


def group_mesh(n_devices: int | None = None, devices=None) -> GroupMesh:
    """Build a 2D ``(g, s)`` mesh over the first ``n_devices`` of
    ``devices`` (default :func:`local_devices`: the CUDA devices).

    The sequence axis gets a factor of 2 when the device count allows
    (even and >= 4); otherwise all devices go to the group axis.  An
    ``n_devices`` below 1 or above the count available raises
    ValueError: the mesh is never silently truncated.
    """
    devs = local_devices() if devices is None else [
        torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"mesh device count must be positive, "
                             f"got {n_devices}")
        if n_devices > len(devs):
            raise ValueError(f"{n_devices} mesh devices requested but "
                             f"only {len(devs)} available")
        devs = devs[:n_devices]
    n = len(devs)
    s = 2 if (n >= 4 and n % 2 == 0) else 1
    g = n // s
    return GroupMesh([devs[i * s:(i + 1) * s] for i in range(g)])


def check_group_divisible(mesh: GroupMesh, g: int) -> None:
    """Raise ValueError unless ``g`` splits evenly over the mesh's
    group axis: the one shared guard for every shard() entry point
    and the servers' pre-disk validation."""
    per = mesh.shape["g"]
    if g % per:
        raise ValueError(f"g={g} not divisible by mesh g-axis {per}")


# -- placement ---------------------------------------------------------------


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _copy_to(block: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A contiguous copy of ``block`` on ``dev`` (never a view)."""
    out = torch.empty(block.shape, dtype=block.dtype, device=dev)
    out.copy_(block)
    return out


def _blocks(t: torch.Tensor, parts: int, axis: int, what: str):
    n = t.shape[axis]
    if n % parts:
        raise ValueError(f"{what}: {n} does not split into {parts} "
                         f"equal blocks")
    return torch.split(t, n // parts, dim=axis) if n else \
        [t] * parts


def shard_leading(mesh: GroupMesh, x, axis: str = "g") -> list:
    """Place ``x`` with its leading axis split over ``axis``: the list
    of its blocks, block ``i`` a contiguous copy on the mesh device of
    index ``i`` along that axis."""
    t = _tensor(x)
    devs = [row[0] for row in mesh.devices] if axis == "g" \
        else list(mesh.devices[0])
    return [_copy_to(b, d) for b, d in zip(
        _blocks(t, len(devs), 0, f"leading axis over {axis!r}"), devs)]


def shard_grid(mesh: GroupMesh, buf) -> list[list[torch.Tensor]]:
    """Place ``buf`` [N, L] over ``('g', 's')``: rows over ``g``, bytes
    over ``s``; block ``(i, j)`` is a contiguous copy of rows
    ``[i N/g, (i+1) N/g)`` and bytes ``[j L/s, (j+1) L/s)`` on
    ``mesh.devices[i][j]``, laid out as the raw-CRC kernel reads it."""
    t = _tensor(buf)
    ng, ns = mesh.shape["g"], mesh.shape["s"]
    rows = _blocks(t, ng, 0, "buf rows over 'g'")
    return [[_copy_to(b, d) for b, d in zip(
        _blocks(r, ns, 1, "buf bytes over 's'"), mesh.devices[i])]
        for i, r in enumerate(rows)]


def leading_placer(mesh: GroupMesh, axis: str = "g"):
    """The one recipe for placing per-call [G]-leading HOST inputs
    alongside g-sharded state.  Returns ``put(arr, dtype=None)``: numpy
    conversion, then :func:`shard_leading` (a 0-d value becomes a 0-d
    tensor on the mesh's first device)."""

    def put(arr, dtype=None):
        a = np.asarray(arr, dtype)
        if a.ndim == 0:
            return torch.tensor(a, device=mesh.home)
        return shard_leading(mesh, a, axis)

    return put


def place_step_inputs(mesh: GroupMesh, args):
    """Place a :func:`data_plane_step` argument tuple onto ``mesh`` (the
    one placement recipe the dry run, the config-5 bench and the tests
    use): ``buf`` by :func:`shard_grid`, every [G, ...] / [N] value and
    each ``GroupState`` field by :func:`shard_leading`; ``stored`` as
    int64 holding uint32 (numpy uint32 is converted); the seed stays an
    int."""
    (buf, lens, stored, seed, state, n_new, self_slot, resp_slots,
     resp_idx, resp_mask) = args
    stored = u32_tensor(stored)
    (lens, stored, n_new, self_slot, resp_slots, resp_idx,
     resp_mask) = (shard_leading(mesh, x) for x in (
         lens, stored, n_new, self_slot, resp_slots, resp_idx,
         resp_mask))
    state = GroupState(*(shard_leading(mesh, x) for x in state))
    return (shard_grid(mesh, buf), lens, stored, int(seed) & _MASK32,
            state, n_new, self_slot, resp_slots, resp_idx, resp_mask)


# -- the collectives ---------------------------------------------------------


def _check_placed(mesh: GroupMesh, buf, *leading) -> None:
    ng, ns = mesh.shape["g"], mesh.shape["s"]
    if not (isinstance(buf, (list, tuple)) and len(buf) == ng
            and all(isinstance(r, (list, tuple)) and len(r) == ns
                    for r in buf)):
        raise TypeError(f"buf must be placed by place_step_inputs / "
                        f"shard_grid as a {ng} x {ns} grid of blocks")
    for x in leading:
        if not (isinstance(x, (list, tuple)) and len(x) == ng):
            raise TypeError(f"[G]/[N]-leading inputs must be placed as "
                            f"{ng} g-blocks (shard_leading)")


def all_gather(blocks, device: torch.device) -> torch.Tensor:
    """The g-blocks concatenated onto ``device`` (all_gather over g)."""
    return torch.cat([b.to(device, non_blocking=True) for b in blocks])


def _raw_crc_blocks(buf) -> list[torch.Tensor]:
    """Raw CRC states of every row, per g-block, on the block's first
    device: the kernel (or its plain version) on each (i, j) block, the
    block's state shifted past the ``(s-1-j) L/s`` bytes to its right,
    and the s-blocks XOR-reduced (psum over s)."""
    ns = len(buf[0])
    width = buf[0][0].shape[1]
    nbits = ((ns - 1) * width).bit_length() or 1
    out = []
    for row in buf:
        home = row[0].device
        acc = None
        for j, block in enumerate(row):
            raw = raw_crc_batch(block)
            suffix = (ns - 1 - j) * width
            if suffix:
                raw = shift_crc_batch(raw, torch.full_like(raw, suffix),
                                      nbits=nbits)
            raw = raw.to(home, non_blocking=True)
            acc = raw if acc is None else acc ^ raw
        out.append(acc)
    return out


def _chain_links_local(buf, lens, stored, seed) -> list[torch.Tensor]:
    """Every link of the rolling CRC chain, per g-block: the s-combined
    raw CRCs and the chain seam (ppermute over g: block i's first link
    checks against block i-1's last stored CRC, block 0's against
    ``seed``)."""
    raws = _raw_crc_blocks(buf)
    links = []
    for i, (raw, ln, st) in enumerate(zip(raws, lens, stored)):
        if i == 0:
            links.append(chain_verify_device(seed, st, raw, ln))
            continue
        if st.numel() == 0:
            links.append(torch.zeros((0,), dtype=torch.bool,
                                     device=st.device))
            continue
        head = stored[i - 1][-1:].to(st.device, non_blocking=True)
        links.append(chain_links_device(torch.cat([head, st[:-1]]), st,
                                        raw, ln))
    return links


# ---------------------------------------------------------------------------
# The fused data-plane step on one card, and its mesh-sharded builders.
# ---------------------------------------------------------------------------


def replay_commit_local(buf, lens, stored, seed,
                        match, nmembers, committed, term,
                        log_terms, offset):
    """Single-card fused step: returns ``(links_ok, new_committed)``.

    ``buf`` [N, L] uint8 right-aligned record payloads, ``lens`` [N]
    byte lengths, ``stored`` [N] the rolling CRCs recorded in the WAL
    (int64 holding uint32), ``seed`` the chain seed.  The raft tensors
    are the [G, ...] group-batched state of ops/quorum.py.
    """
    raw = raw_crc_batch(buf)
    links_ok = chain_verify_device(seed, stored, raw, lens)
    new_committed = maybe_commit_batch(
        match, nmembers, committed, term, log_terms, offset)
    return links_ok, new_committed


def data_plane_step(buf, lens, stored, seed, state: GroupState,
                    n_new, self_slot, resp_slots, resp_idx, resp_mask):
    """The flagship single-card step: one fused round of

    1. WAL-chunk CRC chain verification (north-star config 1), and
    2. the batched-raft leader pipeline — append proposals, absorb
       msgAppResp progress, advance quorum commit over all G groups
       (north-star config 4; raft/batched.py:replication_round).

    Returns ``(links_ok [N], state', err [G], n_committed [G])``.  On
    CUDA tensors the raw CRC runs in the hand-written kernel; the
    mesh-sharded form is :func:`make_sharded_step`.
    """
    raw = raw_crc_batch(buf)
    links_ok = chain_verify_device(seed, stored, raw, lens)
    state, err, ncomm = replication_round(
        state, n_new, self_slot, resp_slots, resp_idx, resp_mask)
    return links_ok, state, err, ncomm


def make_sharded_step(mesh: GroupMesh):
    """The mesh-sharded :func:`data_plane_step` (BASELINE config 5).

    Takes the arguments placed by :func:`place_step_inputs` and returns
    ``(links_ok, state, err, ncomm, commit_all)``: ``links_ok`` [N],
    ``err`` and ``ncomm`` [G] as g-blocks, ``state`` a GroupState of
    g-blocks, and ``commit_all`` the whole [G] commit frontier gathered
    onto the mesh's first device.  Each (i, j) block of ``buf`` runs the
    raw CRC (the CUDA kernel on the card) and the s-blocks XOR; each
    g-block steps its groups once (the reference steps the s-replicated
    state on every (i, j)).  Bit-equal to :func:`data_plane_step` on the
    unsplit inputs.
    """
    def run(buf, lens, stored, seed, state, n_new, self_slot,
            resp_slots, resp_idx, resp_mask):
        _check_placed(mesh, buf, lens, stored, n_new, self_slot,
                      resp_slots, resp_idx, resp_mask, *state)
        links_ok = _chain_links_local(buf, lens, stored, seed)
        outs = [replication_round(GroupState(*(f[i] for f in state)),
                                  n_new[i], self_slot[i], resp_slots[i],
                                  resp_idx[i], resp_mask[i])
                for i in range(mesh.shape["g"])]
        sts = [o[0] for o in outs]
        new_state = GroupState(*([st[k] for st in sts]
                                 for k in range(len(GroupState._fields))))
        commit_all = all_gather([st.commit for st in sts], mesh.home)
        return (links_ok, new_state, [o[1] for o in outs],
                [o[2] for o in outs], commit_all)

    return run


def make_replay_commit_step(mesh: GroupMesh):
    """The mesh-sharded :func:`replay_commit_local`.

    ``buf`` placed by :func:`shard_grid`; ``lens``, ``stored`` and the
    [G, ...] raft values (``match``, ``nmembers``, ``committed``,
    ``term``, ``log_terms``, ``offset``) by :func:`shard_leading`.
    Returns ``(links_ok, committed_all)``: the links as g-blocks, the
    new commit frontier gathered onto the mesh's first device.
    """
    def run(buf, lens, stored, seed, match, nmembers, committed, term,
            log_terms, offset):
        raft = (match, nmembers, committed, term, log_terms, offset)
        _check_placed(mesh, buf, lens, stored, *raft)
        links_ok = _chain_links_local(buf, lens, stored, seed)
        new = [maybe_commit_batch(*(x[i] for x in raft))
               for i in range(mesh.shape["g"])]
        return links_ok, all_gather(new, mesh.home)

    return run


# -- the engines' g-split ----------------------------------------------------


class BlockLayout:
    """How an engine holds a [G]-leading batch: ``len(devices)`` equal
    g-blocks, block ``i`` (groups ``[i G/k, (i+1) G/k)``) on
    ``devices[i]``.  One block on one device is the unsharded engine,
    so sharded and unsharded engines run the same per-block code."""

    def __init__(self, g: int, devices):
        self.g = g
        self.devices = tuple(torch.device(d) for d in devices)
        if g % len(self.devices):
            raise ValueError(f"g={g} not divisible by "
                             f"{len(self.devices)} blocks")
        self.block = g // len(self.devices)

    @property
    def home(self) -> torch.device:
        """Where gathered values land and host reads are taken."""
        return self.devices[0]

    @property
    def sharded(self) -> bool:
        return len(self.devices) > 1

    def bounds(self):
        return [(i * self.block, (i + 1) * self.block)
                for i in range(len(self.devices))]

    def put(self, arr, dtype=None, axis: int = 0) -> list[torch.Tensor]:
        """Host array -> its blocks along ``axis`` (copies, one per
        block device)."""
        a = np.asarray(arr, dtype)
        idx = [slice(None)] * a.ndim
        out = []
        for (lo, hi), dev in zip(self.bounds(), self.devices):
            idx[axis] = slice(lo, hi)
            out.append(torch.tensor(np.ascontiguousarray(a[tuple(idx)]),
                                    device=dev))
        return out

    def split(self, t: torch.Tensor, axis: int = 0) -> list[torch.Tensor]:
        """A whole tensor -> its blocks along ``axis``: contiguous copies
        when sharded; the tensor itself, moved to the one device, when
        not."""
        if not self.sharded:
            return [t.to(self.home)]
        return [_copy_to(b, d) for b, d in zip(
            _blocks(t, len(self.devices), axis, "g-split"), self.devices)]

    def gather(self, blocks, axis: int = 0) -> torch.Tensor:
        """Blocks -> one whole tensor on :attr:`home` (one block: the
        block itself)."""
        if len(blocks) == 1:
            return blocks[0]
        return torch.cat([b.to(self.home, non_blocking=True)
                          for b in blocks], dim=axis)

    def split_state(self, st: GroupState) -> list[GroupState]:
        """A whole GroupState -> one GroupState per block."""
        fields = [self.split(x) for x in st]
        return [GroupState(*(f[i] for f in fields))
                for i in range(len(self.devices))]

    def gather_state(self, blocks) -> GroupState:
        """GroupState blocks -> one whole GroupState on :attr:`home`."""
        if len(blocks) == 1:
            return blocks[0]
        return GroupState(*(self.gather([b[k] for b in blocks])
                            for k in range(len(GroupState._fields))))
