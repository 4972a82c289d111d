"""A run with the timed path broken underneath, and the control, come out
as not correct: each fault a cell can have is planted in the program at
the tests' size, past the harness's look for a card, and the control's
numbers (the reference at the precision below the configuration's, in
the program's place) are held to the cell's limits.

A plant patches the program where it runs: in this process, or, for a
cell of several ranks, in each rank's process (so the plants are
module-level functions, patching with ``setattr`` by default)."""
import time

import pytest
import torch
import torch.distributed as dist

import repro_torch.sharding as sharding
import repro_torch.train.step as step
from bench_port import harness

import bench_port_tiny as tiny

BENCH = harness.benchmark()


def _mode(name):
    return harness.load_json(harness.ROOT / "traffic" / (
        harness.cell_entry(BENCH, name)["traffic"] + ".json"))["mode"]


TRAIN = [c for c in tiny.cells() if _mode(c).startswith("train")]
SHARDED = [c for c in tiny.cells() if _mode(c) == "train_sharded"]
FORWARD = [c for c in tiny.cells() if _mode(c) == "forward"]


def frozen(set_=setattr):
    """A step that returns its state unchanged."""
    def apply(state, grads, metrics, lr_scale, tcfg, opt, sched, norm=None):
        return (step.TrainState(state.params, state.opt, state.step + 1),
                dict(metrics, grad_norm=torch.zeros(()), lr=0.0))
    set_(step, "apply_gradients", apply)


def half_batch(set_=setattr):
    """Half of the batch left out, the mean taken over the rest."""
    loss_fn = step.loss_fn

    def half(model, params, batch, tcfg):
        rows = max(1, batch["tokens"].shape[0] // 2)
        return loss_fn(model, params,
                       {k: v[:rows] for k, v in batch.items()}, tcfg)
    set_(step, "loss_fn", half)


def token_altered(set_=setattr):
    """A token of the batch altered where the loss reads it."""
    loss_fn = step.loss_fn

    def altered(model, params, batch, tcfg):
        labels = batch["labels"].clone()
        labels[0, 0] = (labels[0, 0] + 1) % model.cfg.vocab_size
        return loss_fn(model, params, dict(batch, labels=labels), tcfg)
    set_(step, "loss_fn", altered)


def no_exchange(set_=setattr):
    """The gradients' reduce-scatter between ranks left out: each rank
    keeps its own block of its own gradient."""
    def local(out, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        out.copy_(x.reshape(n, -1)[r].reshape(out.shape))
    set_(sharding, "_reduce_scatter", local)


def half_rows(logits):
    out = logits.clone()
    out[logits.shape[0] // 2:] = 0
    return out


def answer_altered(logits):
    out = logits.clone()
    out[0, 3] = out[0, 3].roll(1)
    return out


def _correct(name, plant, monkeypatch) -> bool:
    cfg, tr = tiny.files(name)
    cell = harness.make_cell(BENCH, name, tiny.SEED, 0.2, False, "cpu",
                             time.monotonic(), cfg, tr)
    mode = harness.mode_of(cell)
    if tr["mode"] == "train_sharded":
        out = mode.run(cell, plant=plant)
    else:
        plant(monkeypatch.setattr)
        out = mode.run(cell)
    return harness.judge(out.compare(), harness.limits(name))[0]


@pytest.mark.parametrize("plant", [frozen, half_batch, token_altered])
@pytest.mark.parametrize("name", TRAIN)
def test_train_fault(monkeypatch, name, plant):
    assert not _correct(name, plant, monkeypatch)


@pytest.mark.parametrize("name", SHARDED)
def test_exchange_left_out(monkeypatch, name):
    assert not _correct(name, no_exchange, monkeypatch)


@pytest.mark.parametrize("breaks", [half_rows, answer_altered])
@pytest.mark.parametrize("name", FORWARD)
def test_forward_fault(monkeypatch, name, breaks):
    make = step.make_forward

    def make_broken(model, **kw):
        fwd = make(model, **kw)

        def forward(params, batch):
            logits, aux = fwd(params, batch)
            return breaks(logits), aux
        return forward

    def plant(set_):
        set_(step, "make_forward", make_broken)
    assert not _correct(name, plant, monkeypatch)


@pytest.mark.parametrize("name", tiny.cells())
def test_control_is_not_correct(name):
    cfg, tr = tiny.files(name)
    cell = harness.make_cell(BENCH, name, tiny.SEED, 0, False, "cpu", 0.0,
                             cfg, tr)
    numbers = harness.mode_of(cell).control(cell)["fp8"]
    correct, checks = harness.judge(numbers, harness.limits(name))
    assert not correct, checks
