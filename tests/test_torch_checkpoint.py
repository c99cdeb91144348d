"""The port's checkpoint manager (`repro_torch.checkpoint.manager`) — the
reference's tests of `tests/test_checkpoint_recovery.py` and the
checkpoint tests of `tests/test_substrates.py`, in torch's own format:

* round trip of a nested tree (dicts, lists, NamedTuples, bf16) and the
  ``.tmp`` directory invisible to restore; ``keep`` GC; a multi-host
  commit; ``save_sync``;
* the finalize timeout, then a late host's commit publishes the step;
* a live engine's u32 counters (int64 carriers, wrapped past 2³²) round
  trip bit for bit; the leaf keys are the reference's key paths;
* a torn shard makes ``restore`` raise; restore puts leaves on the
  proto's dtype as fresh storage.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch

import test_torch_resilience as ttr
import test_torch_step as tts

from repro.checkpoint.manager import _flatten as j_flatten
from repro.serving.engine_state import rid_token_fn as j_rid
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.resilience import tear_checkpoint
from repro_torch.serving.engine_state import rid_token_fn


class Pair(NamedTuple):
    a: torch.Tensor
    b: tuple


def _tree(shift=0.0):
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3) + shift,
            "b": {"c": torch.ones(4, dtype=torch.bfloat16) + shift},
            "lst": [torch.zeros(2), torch.full((3,), 7.0 + shift)],
            "nt": Pair(a=torch.tensor([1, 2], dtype=torch.int32),
                       b=(torch.tensor(5, dtype=torch.int64), None)),
            "empty": ()}


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    ck.save(3, _tree(), blocking=True)
    ck.save(7, _tree(1.0), blocking=True)
    assert ck.complete_steps() == [3, 7]
    got, step = ck.restore(_tree())
    assert step == 7
    want = _tree(1.0)
    assert torch.equal(got["a"], want["a"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], want["b"]["c"])
    assert torch.equal(got["lst"][1], want["lst"][1])
    assert isinstance(got["nt"], Pair) and got["nt"].b[1] is None
    assert torch.equal(got["nt"].a, want["nt"].a) and got["empty"] == ()
    got3, _ = ck.restore(_tree(), step=3)
    assert torch.equal(got3["a"], _tree()["a"])
    # a torn checkpoint (tmp dir) is invisible
    (tmp_path / "step_000000099.tmp").mkdir()
    assert ck.latest_step() == 7
    shard = tmp_path / "step_000000007" / "shard_00000.pt"
    flat = torch.load(shard, weights_only=True)
    assert sorted(flat) == ["a", "b/c", "lst/0", "lst/1", "nt/a", "nt/b/0"]


def test_checkpoint_gc_keeps_newest(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.ones(2)}, blocking=True)
    assert ck.complete_steps() == [3, 4]


def test_checkpoint_multihost_commit(tmp_path):
    """Finalize waits for every host's commit marker (simulated hosts)."""
    tree = {"x": torch.ones(2)}
    h0 = CheckpointManager(str(tmp_path), host_id=0, expected_hosts=2)
    h1 = CheckpointManager(str(tmp_path), host_id=1, expected_hosts=2)
    t = threading.Thread(target=h0.save, args=(5, tree),
                         kwargs={"blocking": True})
    t.start()
    time.sleep(0.1)
    assert h0.complete_steps() == []  # host 1 not committed yet
    h1.save(5, tree, blocking=True)
    t.join(timeout=30)
    assert h0.complete_steps() == [5]


def test_emergency_save_sync_restorable(tmp_path):
    """``save_sync`` bypasses the writer-slot queue and still publishes a
    complete, restorable checkpoint."""
    m = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "ctr": torch.tensor([7, (1 << 32) - 1], dtype=torch.int64)}
    m.save_sync(5, tree)
    assert m.complete_steps() == [5]
    got, step = m.restore({"w": torch.zeros(3, 4),
                           "ctr": torch.zeros(2, dtype=torch.int64)})
    assert step == 5
    assert torch.equal(got["w"], tree["w"])
    assert torch.equal(got["ctr"], tree["ctr"])
    assert m.io_telemetry() == {"writers_queued": 0, "slots_free": 2}


def test_try_finalize_timeout_then_late_host_commits(tmp_path):
    """Host 0 of 2 saves alone: finalize gives up after its timeout without
    publishing; once host 1's shard and commit land, a re-finalize
    publishes and restore merges both shards."""
    h0 = CheckpointManager(str(tmp_path), host_id=0, expected_hosts=2,
                           finalize_timeout=0.05)
    h0.save_sync(3, {"a": torch.tensor([1, 2], dtype=torch.int64)})
    assert h0.complete_steps() == []  # torn: invisible to restore
    assert not h0._try_finalize(3)
    with pytest.raises(FileNotFoundError):
        h0.restore({"a": torch.zeros(2, dtype=torch.int64)})
    h1 = CheckpointManager(str(tmp_path), host_id=1, expected_hosts=2,
                           finalize_timeout=0.05)
    h1.save_sync(3, {"b": torch.tensor([3.0])})
    assert h0._try_finalize(3, timeout=5.0)
    assert h0.complete_steps() == [3]
    got, _ = h0.restore({"a": torch.zeros(2, dtype=torch.int64),
                         "b": torch.zeros(1)})
    assert got["a"].tolist() == [1, 2] and got["b"].tolist() == [3.0]


def test_u32_counters_round_trip_bit_exact(tmp_path):
    """The rung-4 snapshot payload: a live engine's QoS state and block
    pool (u32 tickets and grants as int64 carriers, wrapped past 2³²)
    restore with the same dtype and bits; every key is the reference's
    key path, and every value its JAX twin's after the same megastep."""
    mode = "chunked"
    trace = tts._trace(mode, 3, 8, 0.0)
    eng = ttr._engine("port", mode, [0.0], watchdog=3, wrap=True)
    jeng = ttr._engine("jax", mode, [0.0], watchdog=3, wrap=True)
    for e, R, fn in ((eng, tts.TRequest, rid_token_fn),
                     (jeng, tts.JRequest, j_rid)):
        e.submit_batch([R(**t) for t in trace])
        e.megastep(4, token_fn=fn,
                   nows=np.asarray([k * tts.DT for k in range(4)],
                                   np.float32))
    tree = {"qos": eng.qos, "kv": eng._kv_state}
    m = CheckpointManager(str(tmp_path))
    m.save_sync(1, tree)
    got, _ = m.restore(tree)
    flat, flat_got = _flatten(tree), _flatten(got)
    jflat, _ = j_flatten({"qos": jeng.qos, "kv": jeng._kv_state})
    assert list(flat) == list(jflat) and "kv/pool/sema/grant" in flat
    wrapped = False
    for k, a in flat.items():
        b = flat_got[k]
        assert a.dtype == b.dtype and torch.equal(a, b), k
        j = jflat[k]
        want = a.numpy().astype(np.uint32) if j.dtype == np.uint32 \
            else a.numpy()
        np.testing.assert_array_equal(want, j, err_msg=k)
        if j.dtype == np.uint32 and (j > np.uint32(1 << 31)).any():
            wrapped = True
    assert wrapped  # the run really carried wrapped counters


def test_torn_shard_makes_restore_raise(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=4)
    ck.save_sync(1, {"x": torch.arange(1000.0)})
    ck.save_sync(2, {"x": torch.arange(1000.0) + 1})
    assert tear_checkpoint(ck) == 1
    with pytest.raises(Exception):
        ck.restore({"x": torch.zeros(1000)})
    got, step = ck.restore({"x": torch.zeros(1000)}, step=1)
    assert step == 1 and torch.equal(got["x"], torch.arange(1000.0))
    assert tear_checkpoint(CheckpointManager(str(tmp_path / "none"))) == 0


def test_restore_casts_to_the_proto_in_fresh_storage(tmp_path):
    """Restore puts each leaf on the proto leaf's dtype; the restored
    tensors share no storage with the saved tree, and a write into the
    live tree after the save does not reach the checkpoint."""
    live = {"w": torch.arange(8, dtype=torch.float32),
            "v": torch.arange(16, dtype=torch.float32).view(4, 4)[1]}
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, live, blocking=True)
    live["w"][0] = 99.0
    got, _ = ck.restore({"w": torch.zeros(8, dtype=torch.float64),
                         "v": torch.zeros(4)})
    assert got["w"].dtype == torch.float64 and got["w"][0] == 0.0
    assert got["v"].tolist() == [4.0, 5.0, 6.0, 7.0]
    assert got["v"].untyped_storage().nbytes() == 16  # the row, not the
    #                                                   whole 4×4 buffer
    with pytest.raises(TypeError, match="not a tensor"):
        ck.save_sync(2, {"x": np.zeros(2)})


def test_key_paths_are_the_references():
    """The sharing replica (pool, table, prefix cache) flattens to the
    reference's key paths and values, the block counters parked below
    2³² included."""
    from repro_torch.serving.engine_state import KVPool as TKV
    from repro.serving.engine_state import KVPool as JKV

    te = tts._port("sharing", [0.0], wrap=True)
    je = tts._jax("sharing", [0.0], wrap=True)
    flat = _flatten({"qos": te.qos, "kv": TKV(
        pool=te._kv_hpool, tbl=te._kv_htbl, cache=te._kv_cache)})
    jflat, _ = j_flatten({"qos": je.qos, "kv": JKV(
        pool=je._kv_hpool, tbl=je._kv_htbl, cache=je._kv_cache)})
    assert list(flat) == list(jflat)
    assert {"kv/cache/key", "kv/pool/refcnt", "qos/bucket_seq"} <= set(flat)
    for k, j in jflat.items():
        a = flat[k].numpy()
        np.testing.assert_array_equal(
            a.astype(np.uint32) if j.dtype == np.uint32 else a, j, err_msg=k)
