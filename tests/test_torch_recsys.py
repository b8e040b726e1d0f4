"""Port parity of the BERT4Rec serving path (``repro_torch.models.embedding``,
``models/bert4rec.py``, its config and the recsys half of
``launch/steps.py``): on the JAX package's weights (``init_params(...,
jax.random.key(0))`` at the smoke config, carried across with
``convert.params_from_reference``) and the same ``RecsysPipeline`` batch,
``encode``, ``serve_scores`` and ``score_candidates`` equal the
reference's; the EmbeddingBag in every mode, with weights and with -1
padding ids masked; ``sharded_topk`` and the serving and retrieval steps;
and the launcher (``python -m repro_torch.launch.serve_recsys``).

Tolerances: float32 through two blocks, rtol 1e-5 with atol 1e-5 on the
hidden states (layer-normed, |h| ~ 1) and atol 1e-6 on the scores (|s| ~
0.1: item rows are drawn at scale 0.02); the EmbeddingBag's sums rtol
1e-6, atol 1e-6. The serving steps run at an item vocabulary of 4,096:
the reference's top 100 over 16 shards needs 100 items a shard, more than
the smoke config's 1,024 items hold. Top-k
(``sharded_topk`` on one score array): values and indices exact, ties
broken toward the lower index as ``jax.lax.top_k`` breaks them, also where
equal values straddle the k-th place (the retrieval candidates are drawn
with replacement, so duplicate items tie).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as jregistry
import repro.launch.steps as jsteps
from repro.configs import get_arch as jget_arch
from repro.data.pipeline import RecsysPipeline as JRecsysPipeline
from repro.models import bert4rec as jb4r
from repro.models.embedding import embedding_bag as jembedding_bag
from repro.models.embedding import embedding_bag_ragged as jembedding_bag_ragged
from repro.models.param import init_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import convert
from repro_torch.configs import get_arch, registry
from repro_torch.data import RecsysPipeline
from repro_torch.launch import serve_recsys, steps
from repro_torch.models import bert4rec as b4r
from repro_torch.models.embedding import embedding_bag, embedding_bag_ragged, take_rows

FWD = dict(rtol=1e-5, atol=1e-6)
HIDDEN = dict(rtol=1e-5, atol=1e-5)
STEP_VOCAB = 4096
BAG = dict(rtol=1e-6, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _reference(item_vocab=None):
    jcfg = jget_arch("bert4rec").smoke_config
    if item_vocab:
        jcfg = dataclasses.replace(jcfg, item_vocab=item_vocab)
    return jcfg, init_params(jb4r.param_specs(jcfg), jax.random.key(0))


def _port(item_vocab=None):
    jcfg, params = _reference(item_vocab)
    model = b4r.Bert4Rec(convert.bert4rec_config_from_reference(jcfg), device="cpu")
    return convert.params_from_reference(model, _np(params))


def _batch(B, seed=1, step=0, item_vocab=None):
    jcfg, _ = _reference(item_vocab)
    pipe = RecsysPipeline(jcfg.item_vocab, B, jcfg.seq_len, jcfg.n_mask, jcfg.n_negatives,
                          jcfg.n_context, seed=seed, device="cpu")
    return {k: v.numpy() for k, v in pipe.batch_at(step).items()}


# --------------------------------------------------------------- EmbeddingBag


def _bag_inputs(seed=6):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (4, 6)).astype(np.int32)
    valid = rng.random((4, 6)) > 0.3
    valid[2] = False  # an empty bag
    weights = rng.random((4, 6)).astype(np.float32)
    return table, ids, valid, weights


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode, masked, weighted):
    table, ids, valid, weights = _bag_inputs()
    kw = dict(mode=mode)
    want = jembedding_bag(table, ids, weights=weights if weighted else None,
                          valid=valid if masked else None, **kw)
    got = embedding_bag(_t(table), _t(ids), weights=_t(weights) if weighted else None,
                        valid=_t(valid) if masked else None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAG)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_masks_padding_ids(mode):
    """-1 padding ids masked by ``valid = ids >= 0`` (BERT4Rec's context bag):
    the reference's ``where`` drops the rows ``jnp.take`` read for them."""
    table, ids, _, _ = _bag_inputs(7)
    ids[:, 4:] = -1
    ids[3] = -1  # a bag of padding only
    valid = ids >= 0
    want = jembedding_bag(table, ids, mode=mode, valid=valid)
    got = embedding_bag(_t(table), _t(ids), mode=mode, valid=_t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAG)


def test_take_rows_is_jnp_take():
    """-1 reads the last row, an id outside [-V, V) a row of NaN."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[-1, 4], [-5, 0], [3, -4]], np.int32)
    want = np.asarray(jnp.take(table, ids, axis=0))
    got = take_rows(_t(table), _t(ids)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_ragged_matches_reference(mode):
    table, ids, _, _ = _bag_inputs(8)
    flat = ids.reshape(-1)
    seg = np.repeat(np.arange(4), 6).astype(np.int32)
    seg[seg == 1] = 2  # bag 1 empty
    want = jembedding_bag_ragged(table, flat, seg, 5, mode=mode)
    got = embedding_bag_ragged(_t(table), _t(flat), _t(seg), 5, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAG)


# --------------------------------------------------------------- the model


def test_bert4rec_config_matches_reference():
    arch, ref = get_arch("bert4rec"), jget_arch("bert4rec")
    for f in dataclasses.fields(ref):
        got, want = getattr(arch, f.name), getattr(ref, f.name)
        if f.name in ("config", "smoke_config"):
            assert got == convert.bert4rec_config_from_reference(want), f.name
            assert str(got.dtype) == "torch.float32"
        elif f.name == "shapes":
            assert got is registry.RECSYS_SHAPES
        else:
            assert got == want, f.name
    cfg = arch.config
    assert (cfg.item_vocab, cfg.embed_dim, cfg.n_blocks, cfg.n_heads, cfg.seq_len) == (
        1_048_576, 64, 2, 2, 200)


def test_bert4rec_params_are_the_reference_tree():
    jcfg, params = _reference()
    model = _port()
    flat = convert._flatten(_np(params))
    assert set(dict(model.named_parameters())) == set(flat)
    assert "layers.1.wqkv" in flat
    spec = lambda s: (tuple(s.shape), tuple(s.logical), s.init, s.scale)
    assert {k: spec(v) for k, v in convert._flatten(b4r.param_specs(model.cfg)).items()} == {
        k: spec(v) for k, v in convert._flatten(jb4r.param_specs(jcfg)).items()}


@pytest.mark.parametrize("fn", ["encode", "serve_scores", "score_candidates"])
def test_bert4rec_matches_reference(fn):
    jcfg, params = _reference()
    model = _port()
    b = _batch(4)
    b["context_ids"][1, 2:] = -1  # padded context bag
    b["context_ids"][3] = -1  # no context
    args = (b["item_ids"], b["context_ids"])
    if fn == "score_candidates":
        cands = np.random.default_rng(2).integers(0, jcfg.item_vocab, 256).astype(np.int32)
        args += (cands,)
    want = getattr(jb4r, fn)(params, *args, jcfg)
    with torch.no_grad():
        got = getattr(b4r, fn)(model, *map(_t, args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(HIDDEN if fn == "encode" else FWD))


# --------------------------------------------------------------- top-k, steps


def _assert_topk(got, want, scores):
    """Values and indices equal (ties to the lower index, as the
    reference's), and the scores at the returned indices are the values."""
    (gv, gi), (wv, wi) = [tuple(np.asarray(a) for a in x) for x in (got, want)]
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.take_along_axis(scores, gi.astype(np.int64), 1), gv)
    assert all(len(set(row)) == len(row) for row in gi.tolist())


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k,shards", [(10, 4), (100, 16), (7, 1)])
def test_sharded_topk_matches_reference(k, shards, ties):
    rng = np.random.default_rng(k + shards)
    scores = rng.normal(size=(3, 4096)).astype(np.float32)
    if ties:  # duplicate candidates score alike
        scores = np.round(scores, 1)
    want = jsteps.sharded_topk(scores, k, shards)
    got = steps.sharded_topk(_t(scores), k, shards)
    _assert_topk(got, want, scores)


@pytest.mark.parametrize("levels", [2, 5])
@pytest.mark.parametrize("k,shards", [(10, 4), (100, 16), (10, 16), (100, 4)])
def test_sharded_topk_breaks_ties_as_the_reference(k, shards, levels):
    """Fault A: scores from a few levels, so equal values straddle the k-th
    place in every slice and in the merge; ``torch.topk`` alone returned
    other indices. The port's indices are the reference's exactly."""
    rng = np.random.default_rng(k * shards + levels)
    scores = rng.integers(0, levels, (4, 4096)).astype(np.float32)
    scores[1, ::7] = levels  # a row whose top level holds more than k entries
    want = jsteps.sharded_topk(scores, k, shards)
    got = steps.sharded_topk(_t(scores), k, shards)
    _assert_topk(got, want, scores)


@pytest.mark.parametrize("k", [1, 3, 10, 64])
def test_topk_lower_index_is_lax_top_k(k):
    """One stage on its own, rows of a few levels and of distinct values, a
    batch of leading axes."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 3, (2, 3, 64)).astype(np.float32)
    x[1, 2] = rng.permutation(64).astype(np.float32)
    wv, wi = jax.lax.top_k(x, k)
    gv, gi = steps.topk_lower_index(_t(x), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def _small(kind, **kw):
    jcfg, params = _reference(STEP_VOCAB)
    jarch = dataclasses.replace(jget_arch("bert4rec"), config=jcfg)
    arch = dataclasses.replace(get_arch("bert4rec"), config=convert.bert4rec_config_from_reference(jcfg))
    return (arch, jarch, registry.ShapeSpec("small", kind, **kw),
            jregistry.ShapeSpec("small", kind, **kw), params)


@pytest.mark.parametrize("B", [8, 8192])
def test_serve_step_matches_reference(B):
    """``make_recsys_step`` on the serve kind: one chunk (B = 8) and two
    chunks of 4,096 users (B = 8,192), each scored against the full table
    and reduced to its top 100."""
    arch, jarch, shape, jshape, params = _small("serve_scores", batch=B)
    model = _port(STEP_VOCAB)
    b = _batch(B, item_vocab=STEP_VOCAB)
    batch = {k: b[k] for k in ("item_ids", "context_ids")}
    want = jax.jit(jsteps.make_recsys_step(jarch, jshape, JAdamWConfig()))(params, batch)
    got = steps.make_recsys_step(arch, shape, device="cpu")(model, {k: _t(v) for k, v in batch.items()})
    assert got[0].shape == (B, 100) and got[1].shape == (B, 100)
    with torch.no_grad():
        scores = b4r.serve_scores(model, _t(batch["item_ids"]), _t(batch["context_ids"])).numpy()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **FWD)
    np.testing.assert_array_equal(np.take_along_axis(scores, got[1].numpy(), 1), got[0].numpy())
    # the same items, up to scores within the tolerance
    same = (got[1].numpy() == np.asarray(want[1])).mean()
    assert same > 0.99, same


def test_retrieval_step_matches_reference():
    """One user against 4,096 candidates drawn with replacement (duplicates
    tie), top 100, on the same scores."""
    arch, jarch, shape, jshape, params = _small("retrieval", batch=1, n_candidates=4096)
    model = _port(STEP_VOCAB)
    b = _batch(1, item_vocab=STEP_VOCAB)
    cands = np.random.default_rng(2).integers(0, arch.config.item_vocab, 4096).astype(np.int32)
    batch = {"item_ids": b["item_ids"], "context_ids": b["context_ids"], "candidates": cands}
    want = jax.jit(jsteps.make_recsys_step(jarch, jshape, JAdamWConfig()))(params, batch)
    got = steps.make_recsys_step(arch, shape, device="cpu")(model, {k: _t(v) for k, v in batch.items()})
    with torch.no_grad():
        scores = b4r.score_candidates(model, *(_t(batch[k]) for k in
                                               ("item_ids", "context_ids", "candidates")))
    _assert_topk(got, jsteps.sharded_topk(scores.numpy(), 100), scores.numpy())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **FWD)
    assert len(set(cands.tolist())) < len(cands)  # ties exist


@pytest.mark.parametrize("shape_name", sorted(registry.RECSYS_SHAPES))
def test_recsys_input_specs_match_reference(shape_name):
    arch, ref = get_arch("bert4rec"), jget_arch("bert4rec")
    spec = lambda s: (tuple(s.shape), tuple(s.logical), str(s.dtype).split(".")[-1].strip("'>"),
                      s.init)
    got = {k: spec(v) for k, v in steps.recsys_input_specs(arch, arch.shapes[shape_name]).items()}
    want = {k: spec(v) for k, v in jsteps.recsys_input_specs(ref, ref.shapes[shape_name]).items()}
    assert got == want


def test_pipeline_batch_matches_reference():
    jcfg, _ = _reference()
    want = JRecsysPipeline(jcfg.item_vocab, 4, jcfg.seq_len, jcfg.n_mask, jcfg.n_negatives,
                           jcfg.n_context, seed=1).batch_at(0)
    got = _batch(4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_serve_recsys_cli_runs_on_the_cpu(capsys):
    assert serve_recsys.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "req/s" in out and "top-5 items for request 0" in out and "(1, 256)" in out
