"""The port's master-less checkpointing (paper C2), on the CPU: the cases
of ``tests/test_checkpoint.py`` on the port's own format, the streamed
payload (raw bytes, bf16 included; ints in the manifest), fresh tensors
on restore, and the Trainer's restart after a torn write against an
uninterrupted run (params within 1e-5, as the reference's test demands).
"""
import dataclasses as dc
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import (OptimizerConfig, ScheduleConfig,  # noqa: E402
                                TrainConfig, get_config)
from repro_torch.core.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import ShardedDataset  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.train.step import TrainState, init_state  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 8, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.float32),
                       "h": torch.randn(3, 4, generator=g).bfloat16()},
            "stages": [[{"k": torch.randn(2, 3, 1, 1, generator=g)}], []],
            "step_scalar": torch.tensor(7, dtype=torch.int32),
            "count": 7}


def _trees_equal(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and torch.equal(x, y)):
                return False
        elif x != y or type(x) is not type(y):
            return False
    return True


def _payload(tmp_path, worker, step):
    return tmp_path / f"worker_{worker}" / f"step_{step:010d}" / "state.bin"


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), replicas=2)
    t = _tree()
    assert mgr.save(10, t) == 2
    step, restored, extra = mgr.restore_latest("cpu")
    assert step == 10 and extra == {}
    assert _trees_equal(t, restored)
    assert mgr.latest_step() == 10
    # the payload is the leaves' raw bytes, nothing else
    nbytes = sum(x.numel() * x.element_size()
                 for _, x in tree_leaves(t) if isinstance(x, torch.Tensor))
    assert os.path.getsize(_payload(tmp_path, 1, 10)) == nbytes
    assert mgr.last_save["bytes"] == nbytes
    assert mgr.last_save["replicas"] == 2


def test_restore_gives_fresh_tensors(tmp_path):
    """The in-place optimizers would otherwise step one state twice."""
    mgr = CheckpointManager(str(tmp_path), replicas=1)
    t = _tree()
    mgr.save(1, t)
    a = mgr.restore_latest("cpu")[1]
    b = mgr.restore_latest("cpu")[1]
    a["w"].add_(1.0)
    assert torch.equal(b["w"], t["w"]) and not torch.equal(a["w"], t["w"])
    assert a["w"].data_ptr() != t["w"].data_ptr()


def test_train_state_roundtrip(tmp_path):
    cfg = get_config("resnet32-cifar10", reduced=True)
    model = build_model(cfg, "cpu")
    tcfg = TrainConfig(optimizer=OptimizerConfig(name="adamw"))
    st = init_state(model, tcfg)
    st = TrainState(params=st.params, opt={**st.opt, "count": 3}, step=12)
    mgr = CheckpointManager(str(tmp_path), replicas=1)
    mgr.save(st.step, st)
    step, got, _ = mgr.restore_latest("cpu")
    assert step == 12 and isinstance(got, TrainState)
    assert got.step == 12 and got.opt["count"] == 3
    assert type(got.params["stages"]) is list
    assert _trees_equal(got.params, st.params)
    assert _trees_equal(got.opt, st.opt)


def test_newest_wins_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), replicas=2, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    step, restored, _ = mgr.restore_latest("cpu")
    assert step == 4
    assert _trees_equal(_tree(4), restored)
    kept = sorted(os.listdir(tmp_path / "worker_0"))
    assert len(kept) == 2                                 # gc'd to keep=2


def test_corrupted_replica_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), replicas=2)
    mgr.save(5, _tree(5))
    _payload(tmp_path, 0, 5).write_bytes(b"garbage")
    step, restored, _ = mgr.restore_latest("cpu")
    assert step == 5                                      # replica 1 serves
    assert _trees_equal(_tree(5), restored)


@pytest.mark.parametrize("damage", ["flip", "manifest", "truncate",
                                    "append"])
def test_damaged_replica_falls_back(tmp_path, damage):
    """One flipped bit (a bf16 leaf's raw bytes: the checksum covers
    them), a torn manifest, a short or a long payload: each replica is
    skipped and the other serves."""
    mgr = CheckpointManager(str(tmp_path), replicas=2)
    t = _tree(3)
    mgr.save(5, t)
    p = _payload(tmp_path, 0, 5)
    raw = bytearray(p.read_bytes())
    if damage == "flip":
        off = 0                                # the bf16 leaf's first byte
        for k, x in tree_leaves(t):
            if k == "nested/h":
                break
            off += x.numel() * x.element_size()
        raw[off] ^= 1
        p.write_bytes(bytes(raw))
    elif damage == "manifest":
        m = p.parent / "manifest.json"
        m.write_text(m.read_text()[:-7])
    elif damage == "truncate":
        p.write_bytes(bytes(raw[:-1]))
    else:
        p.write_bytes(bytes(raw) + b"\0")
    step, restored, _ = mgr.restore_latest("cpu")
    assert step == 5 and _trees_equal(t, restored)
    assert mgr.latest_step() == 5


def test_tampered_manifest_is_refused(tmp_path):
    """The structure and its ints are part of the checksum."""
    mgr = CheckpointManager(str(tmp_path), replicas=1)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    m = _payload(tmp_path, 0, 2).parent / "manifest.json"
    meta = json.loads(m.read_text())
    meta["tree"]["dict"]["count"] = {"int": 8}
    m.write_text(json.dumps(meta))
    step, restored, _ = mgr.restore_latest("cpu")
    assert step == 1 and _trees_equal(_tree(1), restored)


def test_all_replicas_corrupt_falls_back_to_older_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), replicas=2)
    mgr.save(5, _tree(5))
    mgr.save(6, _tree(6))
    for r in (0, 1):
        _payload(tmp_path, r, 6).write_bytes(b"garbage")
    step, restored, _ = mgr.restore_latest("cpu")
    assert step == 5
    assert _trees_equal(_tree(5), restored)


def test_nothing_to_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "none"))
    assert mgr.restore_latest("cpu") is None and mgr.latest_step() is None
    with pytest.raises(TypeError, match="cannot checkpoint"):
        CheckpointManager(str(tmp_path)).save(1, {"x": object()})


def test_mid_write_revocation_never_corrupts(tmp_path):
    """A worker killed mid-write must leave no torn checkpoint behind."""
    mgr = CheckpointManager(str(tmp_path), replicas=1)
    mgr.save(1, _tree(1))
    mgr.fail_after_bytes = 64                  # simulated revocation
    with pytest.raises(RuntimeError):
        mgr.save(2, _tree(2))
    mgr.fail_after_bytes = None
    step, restored, _ = mgr.restore_latest("cpu")
    assert step == 1                           # torn write invisible
    assert _trees_equal(_tree(1), restored)
    # no stray tmp dirs leak
    assert not [d for d in os.listdir(tmp_path / "worker_0")
                if d.startswith(".tmp")]


def test_fast_save_single_replica(tmp_path):
    """The 30-second warning path: one fsync'd replica, restorable."""
    mgr = CheckpointManager(str(tmp_path), replicas=3)
    wrote = mgr.save(42, _tree(42), fast=True,
                     extra={"reason": "revocation_warning"})
    assert wrote == 1
    assert not os.path.exists(tmp_path / "worker_1")
    step, restored, extra = mgr.restore_latest("cpu")
    assert step == 42 and extra["reason"] == "revocation_warning"


def test_partial_replica_failure_still_succeeds(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), replicas=2)
    orig = mgr._open
    calls = {"n": 0}

    def flaky(rdir):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk gone (revoked)")
        return orig(rdir)

    monkeypatch.setattr(mgr, "_open", flaky)
    assert mgr.save(7, _tree(7)) == 1          # one replica survived
    assert mgr.restore_latest("cpu")[0] == 7
    assert mgr.last_save["replicas"] == 1


def test_every_replica_failing_fails_the_save(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), replicas=2)

    def gone(rdir):
        raise OSError("disk gone (revoked)")

    monkeypatch.setattr(mgr, "_open", gone)
    with pytest.raises(OSError, match="disk gone"):
        mgr.save(7, _tree(7))
    assert mgr.restore_latest("cpu") is None


def _trainer_setup():
    cfg = get_config("starcoder2-3b", reduced=True).replace(
        dtype="float32", attn_impl="torch")
    model = build_model(cfg, "cpu")
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(name="adamw", lr=1e-3, base_workers=1),
        schedule=ScheduleConfig(kind="constant", warmup_steps=1,
                                total_steps=8),
        checkpoint_every=1, seed=0)
    ds = ShardedDataset(cfg, global_batch=4, seq_len=8, seed=0,
                        device="cpu")
    return model, tcfg, ds


def test_trainer_resumes_after_mid_write_crash(tmp_path):
    """Crash-consistency end to end (the C3 bound in real training): a
    revocation that truncates a checkpoint mid-write must leave the
    previous valid checkpoint restorable, and the resumed trainer must
    replay from that step to a state identical to an uninterrupted run —
    at most one batch of work lost (checkpoint_every=1). Each run starts
    from its own ``init_state``: the optimizers update in place."""
    model, tcfg, ds = _trainer_setup()

    # reference: uninterrupted 6-step run
    ref = Trainer(model, tcfg, ds)
    ref_state = ref.fit(ref.init_or_restore(), 6)

    # interrupted: 3 clean steps, then the 4th step's save is torn
    mgr = CheckpointManager(str(tmp_path), replicas=1)
    tr = Trainer(model, tcfg, ds, mgr)
    state = tr.init_or_restore()
    state = tr.fit(state, 3)                       # saves land at steps 1..3
    mgr.fail_after_bytes = 64                      # revocation mid-write
    with pytest.raises(RuntimeError, match="mid-write"):
        tr.fit(state, 1)                           # step 4's save is torn
    mgr.fail_after_bytes = None

    # a fresh trainer restores the newest VALID step: 3, not the torn 4
    tr2 = Trainer(model, dc.replace(tcfg, checkpoint_every=0), ds, mgr)
    resumed = tr2.init_or_restore()
    assert resumed.step == 3
    final = tr2.fit(resumed, 3)                    # replay steps 3..5
    assert final.step == ref_state.step == 6
    diffs = [float((a - b).abs().max()) for (_, a), (_, b) in zip(
        tree_leaves(ref_state.params), tree_leaves(final.params))]
    assert max(diffs) < 1e-5
    assert not [d for d in os.listdir(tmp_path / "worker_0")
                if d.startswith(".tmp")]


def test_on_revocation_warning_fast_saves(tmp_path):
    model, tcfg, ds = _trainer_setup()
    mgr = CheckpointManager(str(tmp_path), replicas=2)
    tr = Trainer(model, dc.replace(tcfg, checkpoint_every=0), ds, mgr)
    state = tr.fit(tr.init_or_restore(), 2)
    tr.on_revocation_warning(state)
    assert sorted(os.listdir(tmp_path)) == ["worker_0"]
    step, got, extra = mgr.restore_latest("cpu")
    assert step == 2 and extra == {"reason": "revocation_warning"}
    assert got.step == 2 and got.opt["count"] == 2
    assert _trees_equal(got.params, state.params)
    # the restored state trains on as the saved one does
    a = tr.fit(got, 1)
    b = tr.fit(state, 1)
    assert _trees_equal(a.params, b.params)
    Trainer(model, tcfg, ds).on_revocation_warning(state)  # no ckpt: no-op
    assert np.isfinite(tr.metrics_log[-1]["loss"])


def test_saving_a_step_again_keeps_the_published_copy(tmp_path):
    """A periodic save of step 3, then the warning's fast save of the
    same step: the replica keeps its copy and the save succeeds (the
    reference's ``os.replace`` onto the non-empty directory fails)."""
    mgr = CheckpointManager(str(tmp_path), replicas=2)
    assert mgr.save(3, _tree(3)) == 2
    assert mgr.save(3, _tree(3), fast=True) == 1
    assert sorted(os.listdir(tmp_path / "worker_0")) == ["step_0000000003"]
    step, restored, extra = mgr.restore_latest("cpu")
    assert step == 3 and extra == {} and _trees_equal(_tree(3), restored)
