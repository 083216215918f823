"""The port's sampling (temperature > 0) on the CPU against the JAX package.

The port draws by Gumbel-max over a counter hash (``serve/sampling.py``):
(seed, request id or batch row, absolute position, vocabulary index).  The
draw cannot match ``jax.random``, so tokens are held to distributions, not
to the reference's tokens:
  * the hash: words in [0, 2^32), a pure function of its counters;
  * the sampler over 10^5 counters on fixed logits: total variation within
    0.01 of softmax(logits / T) (16 categories: a multinomial sample of 10^5
    lands within 0.0075 of its law in 99.9% of draws), and
    ``jax.random.categorical`` within the same bound on the same logits;
  * ``generate`` at T = 0.7, 256 rows of one prompt, in both packages, same
    weights (the head scaled so the first token's law is far from uniform):
    the two first-token histograms within a two-sample bound, the 99.9%
    quantile of the TV between two independent 256-draw samples of the
    first token's law (simulated with numpy);
  * T = 1e-4 gives the greedy tokens (``generate`` and the engine);
  * the engine: a reset replays a sampled run identically (as the
    reference's tests/test_serve_continuous.py), the draw does not depend on
    the slot or the batch, a sampled request beside greedy ones leaves
    theirs untouched, and the launcher's ``--temperature``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.models.transformer import make_model as jax_make_model
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import generate as jax_generate
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as serve_launch
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine, ServeConfig, generate
from repro_torch.serve.sampling import counter_bits, gumbel, sample
from repro_torch.serve.scheduler import Request
from repro_torch.serve.workload import required_max_seq, seeded_requests

ARCH = "internlm2-1.8b"
TV_BOUND = 0.01  # 16 categories, 10^5 draws
HEAD_SCALE = 25.0  # the reduced model's random head gives near-uniform logits


@pytest.fixture(scope="module")
def weights():
    """The reduced model's JAX params as numpy (f32), the head scaled by
    HEAD_SCALE; the port's prepared copy."""
    jcfg = jax_reduce_config(jax_get_config(ARCH), dtype="float32")
    jparams = jax.tree.map(np.asarray, jax_make_model(jcfg).init(jax.random.PRNGKey(0)))
    jparams["lm_head"]["w"] = jparams["lm_head"]["w"] * HEAD_SCALE
    model = make_model(reduce_config(get_config(ARCH), dtype="float32"))
    master = params_from_numpy(model, jparams, device="cpu")
    return jcfg, jparams, model, master


def _tv(a, b) -> float:
    return 0.5 * float(np.abs(np.asarray(a) - np.asarray(b)).sum())


# ------------------------------------------------------------------- hash --
def test_counter_bits_are_a_pure_function_of_their_counters():
    streams, pos = torch.tensor([0, 1, 7, 2**40 + 3]), torch.tensor([5, 5, 0, 2**33])
    bits = counter_bits(9, streams, pos, 50)
    assert bits.dtype == torch.int64 and tuple(bits.shape) == (4, 50)
    assert int(bits.min()) >= 0 and int(bits.max()) < 2**32
    assert torch.equal(bits, counter_bits(9, streams.clone(), pos.clone(), 50))
    # each counter moves the words: seed, stream, position, vocabulary index
    assert not torch.equal(bits, counter_bits(10, streams, pos, 50))
    assert not torch.equal(bits[0], bits[1]) and not torch.equal(bits[1], bits[2])
    assert len(set(bits[0].tolist())) == 50
    g = gumbel(bits)
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())


def test_sample_is_greedy_at_zero_temperature_per_row():
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 32)).astype(np.float32))
    temps = torch.tensor([0.0, 0.7, 0.0, 2.0])
    rows, pos = torch.arange(4), torch.full((4,), 11)
    got = sample(logits, temps, 0, rows, pos)
    assert got[0] == logits[0].argmax() and got[2] == logits[2].argmax()
    g = gumbel(counter_bits(0, rows, pos, 32))
    for r in (1, 3):
        assert got[r] == (logits[r] / temps[r] + g[r]).argmax()


# ----------------------------------------------------------- distribution --
@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_sampler_distribution_within_tv_of_softmax_as_jax(temperature):
    logits = np.random.default_rng(0).normal(size=16).astype(np.float32) * 1.5
    p = np.exp(logits / temperature - (logits / temperature).max())
    p /= p.sum()
    n = 100_000
    toks = sample(torch.from_numpy(logits).expand(n, -1), torch.full((n,), temperature), 3,
                  torch.zeros(n, dtype=torch.long), torch.arange(n)).numpy()
    mine = np.bincount(toks, minlength=16) / n
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jtoks = np.asarray(jax.vmap(
        lambda k: jax.random.categorical(k, jnp.asarray(logits) / temperature))(keys))
    ref = np.bincount(jtoks, minlength=16) / n
    assert _tv(mine, p) <= TV_BOUND, _tv(mine, p)
    assert _tv(ref, p) <= TV_BOUND, _tv(ref, p)
    # the bound has power: the law at another temperature lies past it
    q = np.exp(logits / (2 * temperature) - (logits / (2 * temperature)).max())
    assert _tv(mine, q / q.sum()) > 3 * TV_BOUND


def test_generate_first_token_histogram_matches_jax(weights):
    """256 rows of one prompt at T = 0.7 through ``generate`` in both
    packages: their first-token histograms lie within the 99.9% quantile of
    the TV between two independent 256-draw samples of the first token's
    law (softmax of the port's prefill logits / T), and each lies within
    that of the law itself."""
    jcfg, jparams, model, master = weights
    params = model.prepare(master, "cpu")
    rows, t = 256, 0.7
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab, size=9).astype(np.int32)
    batch = np.repeat(prompt[None], rows, axis=0)
    mine = generate(model, params, {"tokens": batch},
                    ServeConfig(max_new_tokens=1, temperature=t, seed=1))[:, -1].numpy()
    ref = np.asarray(jax_generate(jax_make_model(jcfg), jax.tree.map(jnp.asarray, jparams),
                                  {"tokens": jnp.asarray(batch)},
                                  JaxServeConfig(max_new_tokens=1, temperature=t, seed=1)))[:, -1]
    logits, _ = model.prefill(params, {"tokens": torch.from_numpy(prompt[None])})
    z = logits[0, -1].double().numpy() / t
    p = np.exp(z - z.max())
    p /= p.sum()
    rng = np.random.default_rng(0)
    vocab = p.shape[0]
    null = [_tv(rng.multinomial(rows, p), rng.multinomial(rows, p)) / rows for _ in range(4000)]
    bound = float(np.quantile(null, 0.999))
    h_mine, h_ref = (np.bincount(x, minlength=vocab) / rows for x in (mine, ref))
    assert _tv(h_mine, h_ref) <= bound, (_tv(h_mine, h_ref), bound)
    one = float(np.quantile([_tv(rng.multinomial(rows, p) / rows, p) for _ in range(4000)], 0.999))
    assert _tv(h_mine, p) <= one and _tv(h_ref, p) <= one, (_tv(h_mine, p), _tv(h_ref, p), one)
    assert p.max() > 0.05  # the law is far from uniform over 256 tokens


def test_low_temperature_gives_the_greedy_tokens(weights):
    _, _, model, master = weights
    params = model.prepare(master, "cpu")
    batch = {"tokens": np.random.default_rng(5).integers(0, 256, size=(3, 7)).astype(np.int32)}
    greedy = generate(model, params, batch, ServeConfig(max_new_tokens=6))
    assert torch.equal(generate(model, params, batch,
                                ServeConfig(max_new_tokens=6, temperature=1e-4)), greedy)
    reqs = seeded_requests(256, 4, 4, 12, 5, seed=3)

    def run(t):
        eng = ContinuousEngine(model, master, num_slots=2, max_seq=required_max_seq(reqs),
                               cfg=ServeConfig(temperature=t), chunk=4, device="cpu")
        return {c.request_id: c.tokens.tolist() for c in eng.run(reqs)}

    assert run(1e-4) == run(0.0)


# ----------------------------------------------------------------- engine --
def _sampled_run(model, master, reqs, num_slots, **kw):
    eng = ContinuousEngine(model, master, num_slots=num_slots, max_seq=required_max_seq(reqs),
                           cfg=ServeConfig(temperature=0.7, seed=5), chunk=4, device="cpu", **kw)
    return eng, {c.request_id: c.tokens.tolist() for c in eng.run(reqs)}


def test_engine_reset_replays_a_sampled_run_identically(weights):
    _, _, model, master = weights
    reqs = seeded_requests(256, 3, 8, 8, 4, seed=31)
    eng, first = _sampled_run(model, master, reqs, 2)
    eng.reset()
    assert {c.request_id: c.tokens.tolist() for c in eng.run(reqs)} == first
    greedy = ContinuousEngine(model, master, num_slots=2, max_seq=required_max_seq(reqs),
                              chunk=4, device="cpu")
    assert {c.request_id: c.tokens.tolist() for c in greedy.run(reqs)} != first


def test_engine_draw_does_not_depend_on_slot_or_batch(weights):
    """Keyed on (seed, request id, position): the same requests through 1
    and through 3 slots (other slots, other batches, other ticks) draw the
    same tokens; a sampled request beside greedy ones leaves theirs as a
    greedy run gives them."""
    _, _, model, master = weights
    reqs = seeded_requests(256, 4, 4, 13, 5, seed=8)
    _, one = _sampled_run(model, master, reqs, 1)
    _, three = _sampled_run(model, master, reqs, 3)
    assert one == three
    mixed = [Request(id=r.id, tokens=r.tokens, max_new_tokens=r.max_new_tokens,
                     arrival_step=r.arrival_step, temperature=0.9 if r.id == 1 else None)
             for r in reqs]
    greedy = ContinuousEngine(model, master, num_slots=2, max_seq=required_max_seq(reqs),
                              chunk=4, device="cpu")
    want = {c.request_id: c.tokens.tolist() for c in greedy.run(reqs)}
    got = {c.request_id: c.tokens.tolist() for c in ContinuousEngine(
        model, master, num_slots=2, max_seq=required_max_seq(reqs), chunk=4,
        device="cpu").run(mixed)}
    assert all(got[i] == want[i] for i in want if i != 1)
    assert got[1] != want[1]


def test_launch_serves_sampled_and_skips_the_oracle(capsys):
    out = serve_launch.main(["--smoke", "--continuous", "--device", "cpu", "--requests", "3",
                             "--num-slots", "2", "--new-tokens", "3", "--max-prompt", "12",
                             "--temperature", "0.8", "--no-sentinels"])
    assert len(out["completions"]) == 3 and "static_identical" not in out
    assert not out["engine"].sentinels
    text = capsys.readouterr().out
    assert "sentinels off" in text and "token-identical" not in text
    out = serve_launch.main(["--smoke", "--device", "cpu", "--batches", "1", "--new-tokens", "2",
                             "--temperature", "0.8"])
    assert tuple(out["outputs"][0].shape) == (4, 34)
