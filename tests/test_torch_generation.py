"""Generation in the PyTorch port (paddle_tpu_torch/models) against the JAX
reference (paddle_tpu/models), on the CPU, in f32.

The same weights (the reference's `init_params` tree carried over with
`params_from_numpy`) and the same token ids go through both packages.
Logits and caches are compared to a stated tolerance, greedy tokens
exactly. Sampling cannot match across the packages (threefry vs torch's
generators), so it is held to seed reproducibility and batch-independence
within the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import generation as jgen
from paddle_tpu.models import llama_functional as jlf
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import llama_functional as tlf
from paddle_tpu_torch.models.llama import Llama
from paddle_tpu_torch.models.weights import params_from_numpy

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

ARGS = jlf.LlamaArgs(vocab_size=128, hidden_size=64, intermediate_size=176,
                     num_layers=2, num_heads=4, num_kv_heads=2,
                     rope_theta=10000.0, rms_eps=1e-6, use_flash=False)
TARGS = tlf.LlamaArgs(*ARGS)
# f32 logits of magnitude ~0.3: XLA and torch sum in different orders
ATOL = 1e-5
CPU = "cpu"


@pytest.fixture(scope="module")
def jparams():
    return jlf.init_params(ARGS, jax.random.key(0))


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             TARGS, device=CPU)


def _ids(b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, ARGS.vocab_size, size=(b, s)).astype(np.int32)


def test_params_from_numpy_keeps_every_leaf(jparams, model):
    np.testing.assert_array_equal(model.embedding.numpy(),
                                  np.asarray(jparams["embedding"]))
    np.testing.assert_array_equal(model.lm_head.numpy(),
                                  np.asarray(jparams["lm_head"]))
    np.testing.assert_array_equal(model.final_norm.numpy(),
                                  np.asarray(jparams["final_norm"]))
    for k, v in jparams["layers"].items():
        np.testing.assert_array_equal(model.layers[k].numpy(), np.asarray(v))
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    bad["lm_head"] = bad["lm_head"].T      # a transposed layout fails loudly
    with pytest.raises(ValueError, match="lm_head"):
        params_from_numpy(bad, TARGS, device=CPU)


def test_init_params_is_seeded_and_shaped():
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        return Llama(TARGS, tlf.init_params(TARGS, g, device=CPU))

    a, b, c = make(3), make(3), make(4)
    assert len(list(a.parameters())) == 3 + len(tlf.LAYER_KEYS)
    for (name, x), y, z in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        if name.endswith(("ln1", "ln2", "final_norm")):
            assert (x == 1).all()
        else:
            assert not torch.equal(x, z)
            assert abs(x.std().item() - 0.02) < 0.005
    assert a.lm_head.shape == (64, 128)
    assert a.layers["wk"].shape == (2, 64, 32)      # [L, H, nkv * hd]


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        tlf.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(jlf.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        atol=1e-6)
    jc, js = jlf.rope_tables(40, 16, 10000.0)
    tc, ts = tlf.rope_tables(40, 16, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 5, 2, 16)).astype(np.float32)
    jq, jk = jlf.apply_rope(jnp.asarray(q), jnp.asarray(k), jc[:5], js[:5])
    tq, tk = tlf.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                            tc[:5], ts[:5])
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)


@pytest.mark.parametrize("s", [9, 40])   # s*g 18 -> window path; 80 -> masked
def test_forward_cached_prefill_matches_reference(jparams, model, s):
    ids = _ids(2, s)
    last = np.array([s - 1, s // 2], np.int32)
    max_len = 48
    jck, jcv, jcos, jsin = jgen._init_cache(jparams, ARGS, 2, max_len)
    jl, jk, jv = jgen._forward_cached(jparams, jnp.asarray(ids), jck, jcv, 0,
                                      jcos, jsin, ARGS,
                                      last_idx=jnp.asarray(last))
    tck, tcv, tcos, tsin = tgen._init_cache(model, 2, max_len)
    tl, tk, tv = tgen._forward_cached(model, torch.from_numpy(ids), tck, tcv,
                                      0, tcos, tsin,
                                      last_idx=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_decode_step_per_row_and_scalar_pos_match_reference(jparams, model):
    ids = _ids(3, 6, seed=2)
    max_len = 24
    jl, jk, jv = jgen.prefill(jparams, ARGS, ids, max_len)
    tl, tk, tv = tgen.prefill(model, ids, max_len, device=CPU)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    # per-row positions (the continuous-batching step), rows at 6, 3, 0
    pos = np.array([6, 3, 0], np.int32)
    jl2, _, _ = jgen.decode_step(jparams, ARGS, jnp.asarray(tok), jk, jv,
                                 jnp.asarray(pos), max_len)
    tl2, tk2, _ = tgen.decode_step(model, torch.from_numpy(tok), tk.clone(),
                                   tv.clone(), torch.from_numpy(pos), max_len,
                                   device=CPU)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL)
    # a scalar position: every row at 6
    jl3, _, _ = jgen.decode_step(jparams, ARGS, jnp.asarray(tok), jk, jv, 6,
                                 max_len)
    tl3, _, _ = tgen.decode_step(model, torch.from_numpy(tok), tk, tv, 6,
                                 max_len, device=CPU)
    np.testing.assert_allclose(tl3.numpy(), np.asarray(jl3), atol=ATOL)


def test_paged_decode_step_matches_reference(jparams, model):
    rng = np.random.default_rng(3)
    b, ps, P, n_pages = 3, 8, 4, 14
    hd = ARGS.hidden_size // ARGS.num_heads
    shape = (ARGS.num_layers, n_pages, ARGS.num_kv_heads, ps, hd)
    pk = rng.normal(size=shape).astype(np.float32)
    pv = rng.normal(size=shape).astype(np.float32)
    bt = np.zeros((b, P), np.int32)
    bt[0, :3] = [4, 9, 2]
    bt[1, :4] = [5, 6, 7, 8]
    bt[2, :1] = [4]                    # shares row 0's first page
    pos = np.array([17, 31, 0], np.int32)
    tok = np.array([5, 77, 3], np.int32)
    jl, jk, jv = jgen.paged_decode_step(jparams, ARGS, jnp.asarray(tok),
                                        jnp.asarray(pk), jnp.asarray(pv),
                                        jnp.asarray(bt), jnp.asarray(pos), ps)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tl, tk2, tv2 = tgen.paged_decode_step(model, tok, tk, tv, bt, pos, ps,
                                          device=CPU)
    assert tk2 is tk and tv2 is tv     # the pools are written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("b,s", [(2, 9), (1, 20), (3, 4)])
def test_generate_greedy_matches_reference(jparams, model, b, s):
    ids = _ids(b, s, seed=s)
    ref = np.asarray(jgen.generate(jparams, ARGS, ids, max_new_tokens=10))
    out = tgen.generate(model, ids, max_new_tokens=10, device=CPU)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generate_eos_pads_match_reference(jparams, model):
    ids = _ids(3, 7, seed=9)
    base = np.asarray(jgen.generate(jparams, ARGS, ids, max_new_tokens=8))
    eos = int(base[1, 9])               # row 1 stops at its third token
    ref = np.asarray(jgen.generate(jparams, ARGS, ids, max_new_tokens=8,
                                   eos_token_id=eos, pad_token_id=0))
    out = tgen.generate(model, ids, max_new_tokens=8, eos_token_id=eos,
                        pad_token_id=0, device=CPU).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[1, 10:] == 0).all()


@pytest.mark.parametrize("temperature,top_p,top_k", [
    (0.7, 0.9, 0), (1.0, 0.5, 0), (1.3, 0.95, 5),
    (np.array([0.0, 0.8, 1.2, 2.0], np.float32),
     np.array([1.0, 0.7, 0.3, 0.99], np.float32),
     np.array([0, 3, 0, 40], np.int32))])
def test_warp_logits_masks_match_reference(temperature, top_p, top_k):
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(4, 128)) * 3).astype(np.float32)
    jm, jg = jgen._warp_logits(jnp.asarray(logits), temperature, top_p,
                               top_k)
    tm, tg = tgen._warp_logits(torch.from_numpy(logits), temperature,
                               top_p, top_k)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    jm = np.asarray(jm)
    assert (jm > -1e29).any(axis=-1).all()   # the cutoff stays in range
    np.testing.assert_array_equal(tm.numpy() > -1e29, jm > -1e29)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6)


def test_warp_logits_top_p_one_keeps_the_top_k():
    """Where the cumulative probability rounds below top_p = 1.0, the
    reference's out-of-range gather masks every entry (its cutoff is NaN);
    the port keeps the k survivors, as the reference's comment intends."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 128)).astype(np.float32)
    jm, _ = jgen._warp_logits(jnp.asarray(logits), 0.8, 1.0, 0)
    tm, _ = tgen._warp_logits(torch.from_numpy(logits), 0.8, 1.0, 0)
    jm, tm = np.asarray(jm), tm.numpy()
    nan_rows = ~(jm > -1e29).any(axis=-1)
    assert nan_rows.any() and not nan_rows.all()
    np.testing.assert_allclose(tm[~nan_rows], jm[~nan_rows], rtol=1e-6)
    assert (tm[nan_rows] > -1e29).all()    # top_k = 0: every entry stays
    tk, _ = tgen._warp_logits(torch.from_numpy(logits), 0.8, 1.0, 7)
    assert ((tk.numpy() > -1e29).sum(-1) == 7).all()


def test_sampling_is_seeded_and_batch_independent(model):
    ids = _ids(3, 5, seed=21)
    kw = dict(max_new_tokens=12, temperature=0.9, top_p=0.95, device=CPU)
    seeds = [7, 8, 9]
    full = tgen.generate(model, ids, seeds=seeds, **kw)
    again = tgen.generate(model, ids, seeds=seeds, **kw)
    torch.testing.assert_close(full, again, rtol=0, atol=0)
    # row 1 alone, and with its batch-mates reordered, draws the same
    alone = tgen.generate(model, ids[1:2], seeds=[8], **kw)
    swapped = tgen.generate(model, ids[[2, 1]], seeds=[9, 8], **kw)
    torch.testing.assert_close(alone[0], full[1], rtol=0, atol=0)
    torch.testing.assert_close(swapped[1], full[1], rtol=0, atol=0)
    other = tgen.generate(model, ids, seeds=[70, 80, 90], **kw)
    assert not torch.equal(other[:, 5:], full[:, 5:])
    # a greedy row inside a sampling batch stays exact argmax
    mixed = tgen.generate(model, ids, seeds=seeds, max_new_tokens=12,
                          temperature=np.array([0.0, 0.9, 0.9], np.float32),
                          device=CPU)
    greedy = tgen.generate(model, ids[:1], max_new_tokens=12, device=CPU)
    torch.testing.assert_close(mixed[0], greedy[0], rtol=0, atol=0)
