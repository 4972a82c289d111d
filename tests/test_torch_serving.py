"""The port's ServeEngine against the JAX package's
``ServeEngine(attn_impl="pallas")`` (decode kernel in interpret mode),
token for token, on the same weights (reduced starcoder2-3b, float32,
nonzero biases and gammas): block and token prefill, the long-prompt and
prefill overflow guards, ``revoke_slot`` mid-decode, ``begin_drain``
migration to a second engine, and the serve entry point's CLI.

Greedy parity runs in float32: bf16 logits can tie, and argmax would then
pick a side by rounding noise."""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.config import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.builder import build_model as jax_build  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

ARCH = "starcoder2-3b"
BLOCK = 4
SMALL, LARGE = 16, 32                       # the two cache lengths used


def _randomise(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomise(val, rng)
        elif key in ("gamma", "bq", "bk", "bv"):
            tree[key] = rng.normal(0.0, 0.2, val.shape).astype(np.float32)


@pytest.fixture(scope="module")
def sides():
    """Engine factories for both packages over one set of weights. JAX
    engines of one geometry share their compiled steps."""
    jcfg = jax_config(ARCH, reduced=True).replace(dtype="float32",
                                                  attn_impl="pallas")
    jm = jax_build(jcfg)
    tree = jax.tree.map(np.asarray,
                        JL.unbox(jax.jit(jm.init)(jax.random.key(0))))
    _randomise(tree, np.random.default_rng(0))
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    compiled = {}

    def make_jax(max_len, prefill="block"):
        eng = JaxEngine(jm, jparams, max_batch=3, max_len=max_len,
                        prefill=prefill, prefill_block=BLOCK,
                        shared_fns=compiled.get(max_len))
        compiled.setdefault(max_len, eng.shared_fns)
        return eng

    cfg = get_config(ARCH, reduced=True).replace(dtype="float32",
                                                 attn_impl="torch")
    model = build_model(cfg, "cpu")
    params = params_from_numpy(tree, cfg, "cpu")

    def make_torch(max_len, prefill="block"):
        return ServeEngine(model, params, max_batch=3, max_len=max_len,
                           prefill=prefill, prefill_block=BLOCK)

    return {"jax": SimpleNamespace(make=make_jax, Request=JaxRequest),
            "torch": SimpleNamespace(make=make_torch, Request=Request)}


def _requests(side, plens, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [side.Request(rid=i, prompt=rng.integers(1, 512, size=(n,)).tolist(),
                         max_new_tokens=max_new)
            for i, n in enumerate(plens)]


def _waves(side, prefill="block"):
    """More requests than slots; one prompt longer than the cache is
    truncated at submit and retires at the cache's end."""
    eng = side.make(SMALL, prefill)
    reqs = _requests(side, [5, 3, 7, 20, 4], max_new=6)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs) and len(reqs[3].prompt) == SMALL - 1
    return [r.generated for r in reqs]


def _revoke(side):
    eng = side.make(SMALL)
    reqs = _requests(side, [5, 6], max_new=6, seed=7)
    for r in reqs:
        eng.submit(r)
    while not all(len(r.generated) >= 1 for r in reqs):
        eng.step()
    assert eng.revoke_slot(0) is reqs[0] and reqs[0].generated == []
    eng.run_to_completion()
    assert reqs[0].timing.n_restarts == 1
    return [r.generated for r in reqs]


def _hard_revoke(side):
    eng = side.make(SMALL)
    reqs = _requests(side, [5, 6, 4, 3], max_new=6, seed=11)
    for r in reqs:
        eng.submit(r)
    while not all(r is not None and r.generated for r in eng.slots):
        eng.step()
    displaced = eng.hard_revoke()
    assert eng.draining and not eng.has_work()
    return ([r.rid for r in displaced], eng.tokens_lost,
            [r.generated for r in reqs])


def _drain(side, src_len, dst_len, plens, max_new, after):
    """Decode until every request holds ``after`` tokens, then drain the
    engine and resubmit everything to a fresh one."""
    src = side.make(src_len)
    reqs = _requests(side, plens, max_new, seed=3)
    for r in reqs:
        src.submit(r)
    while not all(len(r.generated) >= after for r in reqs):
        src.step()
    migrated = src.begin_drain(grace_tokens=0)
    assert {r.rid for r in migrated} == {r.rid for r in reqs}
    dst = side.make(dst_len)
    for r in migrated:
        assert dst.submit(r)
    dst.run_to_completion()
    assert src.drain_complete and all(r.done for r in reqs)
    return [r.generated for r in reqs], src.tokens_replayed


def test_block_and_token_prefill_match_jax(sides):
    want = _waves(sides["jax"])
    assert _waves(sides["torch"], "block") == want
    assert _waves(sides["torch"], "token") == want


def test_revoke_slot_mid_decode_matches_jax(sides):
    assert _revoke(sides["torch"]) == _revoke(sides["jax"])


def test_hard_revoke_displaces_like_jax(sides):
    rids, lost, generated = _hard_revoke(sides["torch"])
    assert lost > 0 and sorted(rids) == [0, 1, 2, 3]
    assert all(g == [] for g in generated)
    assert (rids, lost, generated) == _hard_revoke(sides["jax"])


def test_drain_migration_matches_jax_and_undisturbed(sides):
    tokens, replayed = _drain(sides["torch"], SMALL, SMALL, [5, 4, 6],
                              max_new=8, after=3)
    assert replayed > 0
    assert (tokens, replayed) == _drain(sides["jax"], SMALL, SMALL,
                                        [5, 4, 6], max_new=8, after=3)
    eng = sides["torch"].make(SMALL)
    reqs = _requests(sides["torch"], [5, 4, 6], max_new=8, seed=3)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert [r.generated for r in reqs] == tokens


def test_replay_past_the_cache_trips_the_prefill_guard(sides):
    """A migration onto a replica with a shorter cache: the replay stream
    no longer fits, so prefill is cut at the cache's end, the overflowing
    decode write is dropped, and the retire guard ends the request — the
    same tokens as the JAX engine."""
    args = (LARGE, SMALL, [14, 9], 12, 4)
    tokens, _ = _drain(sides["torch"], *args)
    assert tokens == _drain(sides["jax"], *args)[0]
    assert len(tokens[0]) < 12                   # ended by the guard


def test_run_to_completion_raises_when_steps_run_out(sides):
    eng = sides["torch"].make(SMALL)
    for r in _requests(sides["torch"], [5, 3], max_new=6):
        eng.submit(r)
    with pytest.raises(RuntimeError, match="max_steps=2"):
        eng.run_to_completion(max_steps=2)


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "5", "--max-batch", "2", "--max-new-tokens", "4"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)
    assert summary["arch"] == "starcoder2-3b" and summary["reduced"]
    assert summary["completed"] == 5 and summary["tokens_decoded"] == 20
    assert summary["device"] == "cpu" and summary["attn_impl"] == "torch"
