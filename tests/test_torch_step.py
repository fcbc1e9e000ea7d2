"""The port's fused data-plane step (etcd_tpu_torch, on the CPU) against
``jax.jit(etcd_tpu.parallel.data_plane_step)`` on the same inputs, and
the port's independence from JAX and from the JAX package.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import __graft_entry__
from etcd_tpu.crc import crc32c as jcrc32c
from etcd_tpu.ops import crc_device as jdev
from etcd_tpu.parallel import data_plane_step as jax_step
from etcd_tpu.parallel import replay_commit_local as jax_replay

import etcd_tpu_torch
from etcd_tpu_torch.entry import entry, example_args
from etcd_tpu_torch.ops.crc_device import u32_numpy, u32_tensor
from etcd_tpu_torch.parallel import data_plane_step, replay_commit_local

ROOT = Path(__file__).resolve().parent.parent


def _assert_step_equal(jout, tout):
    links, state, err, ncomm = tout
    np.testing.assert_array_equal(links.numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(ncomm.numpy(), np.asarray(jout[3]))
    assert ncomm.numpy().dtype == np.asarray(jout[3]).dtype
    for k, v in jout[1]._asdict().items():
        got = getattr(state, k).numpy()
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def _both_args(**kw):
    jargs = __graft_entry__._example_args(**kw)
    targs = example_args(device="cpu", **kw)
    # the port's builder makes the very same inputs
    for a, b in zip(jargs[:3], targs[:3]):
        np.testing.assert_array_equal(np.asarray(a),
                                      np.asarray(b).astype(np.asarray(a).dtype))
    assert int(jargs[3]) == targs[3]
    return jargs, targs


@pytest.mark.parametrize("kw", [{}, dict(n=100, max_len=200, g=40, m=3,
                                         cap=16, seed_val=0)])
def test_step_parity(kw):
    jargs, targs = _both_args(**kw)
    jout = jax.jit(jax_step)(*jargs)
    tout = data_plane_step(*targs)
    _assert_step_equal(jout, tout)
    assert tout[0].all() and not tout[2].any() and (tout[3] == 2).all()


def test_step_parity_corrupted_and_overflowing():
    jargs, targs = _both_args()
    jargs, targs = list(jargs), list(targs)
    stored = u32_numpy(targs[2])
    stored[10] ^= 1
    buf = targs[0].numpy().copy()
    buf[30, -1] ^= 0x80
    g = targs[5].shape[0]
    n_new = np.full(g, 2, np.int32)
    n_new[::5] = 40  # past cap=32: capacity overflow lanes
    resp_mask = np.ones((g, 2), bool)
    resp_mask[1::3, 1] = False  # no quorum on these lanes
    jargs[0], targs[0] = buf, torch.from_numpy(buf)
    jargs[2], targs[2] = stored, u32_tensor(stored)
    jargs[5], targs[5] = n_new, torch.from_numpy(n_new)
    jargs[9], targs[9] = resp_mask, torch.from_numpy(resp_mask)
    jout = jax.jit(jax_step)(*jargs)
    tout = data_plane_step(*targs)
    _assert_step_equal(jout, tout)
    assert sorted(np.flatnonzero(~tout[0].numpy())) == [10, 11, 30]
    assert tout[2].numpy()[::5].all() and tout[2].sum() == len(n_new[::5])
    assert (tout[3] == 0).any() and (tout[3] == 2).any()


def test_replay_commit_local_parity():
    jargs, targs = _both_args()
    js, ts = jargs[4], targs[4]
    jraft = (js.match, js.nmembers, js.commit, js.term, js.log_term,
             js.offset)
    traft = (ts.match, ts.nmembers, ts.commit, ts.term, ts.log_term,
             ts.offset)
    jout = jax_replay(*jargs[:4], *jraft)
    tout = replay_commit_local(*targs[:4], *traft)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError):
        etcd_tpu_torch.default_device()
    assert etcd_tpu_torch.default_device("cpu") == torch.device("cpu")


def test_smoke_host_chain_matches_reference():
    """The vectorised WAL builder that chip_smoke.py uses
    (etcd_tpu_torch.scripts.walgen) against the reference's CRCs: its
    raw CRCs equal raw_crc_batch, its chain crc32c.update."""
    import chip_smoke
    from etcd_tpu_torch.scripts import walgen

    assert chip_smoke.make_wal is walgen.make_wal
    buf, lens, stored = walgen.make_wal(300, 64, 20, 60, 0xDEADBEEF,
                                        seed=5, n_check=300)
    np.testing.assert_array_equal(
        walgen.raw_crcs(buf),
        np.asarray(jdev.raw_crc_batch(buf, use_pallas=False)))
    prev = 0xDEADBEEF
    for i in range(len(lens)):
        prev = jcrc32c.update(prev, buf[i, 64 - lens[i]:].tobytes())
        assert int(stored[i]) == prev


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "etcd_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "etcd_tpu"), (path, name)
