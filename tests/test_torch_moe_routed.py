"""Dense dispatch over the routed rows only (``ExpertsFFN.routed``, ops/
moe_dispatch.py ``routed_order`` / ``routed_rows`` / ``routed_combine``)
against every expert on every token (``all_tokens`` + ``dense_combine``).

* The output and the gradients of x, the four bank leaves and the router
  logits, at several (B, S, E, k), an odd T, an expert no token picks and
  every token on the same two experts, within fp32 rounding (rtol 1e-5,
  with an absolute floor of 1e-6 of each tensor's largest value: the sums
  run in other orders); the bank leaves of experts no token picks get an
  exact 0 in both. Output and gradients repeat bit for bit. The combine
  alone is dense dispatch's bit for bit in bf16.
* One FORDE LM training step with the routed path taken (the module's
  threshold monkeypatched to 0) against the JAX package's dense-dispatch
  step, as ``test_torch_lm_train.test_train_step_matches_jax`` holds it.
* The path choice: routed at and above ``ROUTED_MIN_ROWS`` mean rows an
  expert, dense below it, in a CUDA graph's capture, with an int8 bank, a
  bank split over an expert axis and one split over a model axis; the
  counters ``moe.routed`` / ``moe.dense`` count each call.
"""

from types import SimpleNamespace

import pytest
import torch

from forde_tpu_torch.nn import moe
from forde_tpu_torch.obs import spans
from forde_tpu_torch.ops import moe_dispatch

torch.set_num_threads(1)

D, H = 16, 24


def _bank(e, seed):
    bank = moe.ExpertsFFN(e, H, D)
    g = torch.Generator().manual_seed(seed)
    bank.init_params(g)
    with torch.no_grad():  # nonzero biases, so that their gradients are read too
        bank.b_up.normal_(0.0, 0.1, generator=g)
        bank.b_down.normal_(0.0, 0.1, generator=g)
    return bank


def _logits(b, s, e, seed, case):
    logits = torch.randn(b, s, e, generator=torch.Generator().manual_seed(seed))
    if case == "unpicked":  # expert 0 is in no token's top-k
        logits[..., 0] = -30.0
    elif case == "same_two":  # every token on experts 1 and e - 1
        logits[..., 1] += 40.0
        logits[..., e - 1] += 30.0
    return logits


def _both(bank, x, logits, k, cot):
    """(output, grads) of the routed path and of all_tokens + dense_combine:
    grads of x, w_up, b_up, w_down, b_down and the logits."""
    results = []
    for routed in (True, False):
        x_ = x.clone().requires_grad_(True)
        l_ = logits.clone().requires_grad_(True)
        idx, probs = moe_dispatch.top_k_gating(l_, k)
        if routed:
            out = bank.routed(x_, idx, probs)
        else:
            combine = moe_dispatch.combine_matrix(idx, probs, logits.shape[-1])
            out = moe_dispatch.dense_combine(bank.all_tokens(x_), combine)
        leaves = [x_, bank.w_up, bank.b_up, bank.w_down, bank.b_down, l_]
        grads = torch.autograd.grad(torch.sum(out * cot), leaves)
        results.append((out.detach(), grads))
    return results


def _close(got, want, name):
    floor = 1e-6 * float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=floor, msg=name)


GRADS = ("x", "w_up", "b_up", "w_down", "b_down", "router logits")


@pytest.mark.parametrize("b,s,e,k,case", [
    (2, 8, 4, 2, "random"),
    (1, 33, 8, 2, "random"),  # an odd T
    (3, 5, 8, 1, "random"),
    (2, 16, 8, 3, "random"),
    (2, 12, 4, 2, "unpicked"),
    (1, 17, 8, 2, "same_two"),
])
def test_routed_matches_all_tokens(b, s, e, k, case):
    bank = _bank(e, seed=b * 100 + s)
    gen = torch.Generator().manual_seed(s)
    x = torch.randn(b, s, D, generator=gen)
    cot = torch.randn(b, s, D, generator=gen)
    logits = _logits(b, s, e, seed=e + k, case=case)
    (out, grads), (want, want_grads) = _both(bank, x, logits, k, cot)
    _close(out, want, "output")
    for g, w, name in zip(grads, want_grads, GRADS):
        _close(g, w, name)
    idx, _ = moe_dispatch.top_k_gating(logits, k)
    unpicked = sorted(set(range(e)) - set(idx.reshape(-1).tolist()))
    if case == "unpicked":
        assert unpicked == [0]
    if case == "same_two":
        assert unpicked == [i for i in range(e) if i not in (1, e - 1)]
    for i in unpicked:  # exact zeros on both paths
        for leaf in range(1, 5):
            assert not grads[leaf][i].any() and not want_grads[leaf][i].any(), (i, leaf)


def test_routed_repeats_bit_for_bit():
    bank = _bank(8, seed=3)
    gen = torch.Generator().manual_seed(4)
    x, cot = torch.randn(2, 31, D, generator=gen), torch.randn(2, 31, D, generator=gen)
    logits = _logits(2, 31, 8, seed=5, case="random")
    (out_a, grads_a), _ = _both(bank, x, logits, 2, cot)
    (out_b, grads_b), _ = _both(bank, x, logits, 2, cot)
    assert torch.equal(out_a, out_b)
    assert all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))


def test_routed_order_groups_the_choices_by_expert():
    idx = torch.tensor([[2, 0], [0, 3], [2, 3], [0, 2], [3, 0]])  # 5 tokens, k 2, E 5
    order = moe_dispatch.routed_order(idx, 5)
    assert order.counts.tolist() == [4, 0, 3, 3, 0]
    flat = idx.reshape(-1)
    assert flat[order.perm].tolist() == [0, 0, 0, 0, 2, 2, 2, 3, 3, 3]
    assert order.perm.tolist() == [1, 2, 6, 9, 0, 4, 7, 3, 5, 8]  # stable: choice order kept
    assert torch.equal(order.perm[order.inv], torch.arange(10))
    x = torch.arange(5.0)[:, None].expand(5, 3)
    rows = moe_dispatch.routed_rows(x, order)
    assert rows[:, 0].tolist() == [0, 1, 3, 4, 0, 2, 3, 1, 2, 4]  # token = choice // k


@pytest.mark.parametrize("t,e,k", [(37, 8, 2), (64, 4, 2), (20, 8, 3)])
def test_routed_combine_rounds_as_dense_combine(t, e, k):
    """The same expert outputs mixed by both combines: bit for bit in bf16
    (fp32 products of the rounded gates, summed, rounded once), within
    fp32 rounding in fp32 (the k terms added in another order)."""
    gen = torch.Generator().manual_seed(t)
    idx, probs = moe_dispatch.top_k_gating(torch.randn(1, t, e, generator=gen), k)
    outputs = torch.randn(e, 1, t, 16, generator=gen)
    order = moe_dispatch.routed_order(idx, e)
    expert, token = idx.reshape(-1)[order.perm], order.perm // k
    for dtype in (torch.bfloat16, torch.float32):
        y = outputs.to(dtype)
        want = moe_dispatch.dense_combine(y, moe_dispatch.combine_matrix(idx, probs, e))
        got = moe_dispatch.routed_combine(y[expert, 0, token], order, probs).reshape(1, t, 16)
        assert got.dtype == dtype
        if dtype == torch.bfloat16:
            assert torch.equal(got, want)
        else:
            _close(got, want, "fp32 combine")


def _layer(e=4, k=2, **kw):
    layer = moe.MoELayer(num_experts=e, top_k=k, expert_hidden_dim=H, d_model=D, **kw)
    g = torch.Generator().manual_seed(7)
    layer.router.init_params(g)
    if not layer.experts.quantized:
        layer.experts.init_params(g)
    return layer


def _counts():
    counters = spans.snapshot()[0]
    return counters.get("moe.routed", 0), counters.get("moe.dense", 0)


def _took(layer, x):
    """'routed' or 'dense': the path one forward of ``layer`` took."""
    routed, dense = _counts()
    layer(x)
    after = _counts()
    assert after[0] - routed + after[1] - dense == 1
    return "routed" if after[0] > routed else "dense"


def test_layer_forward_and_grads_match_across_paths(monkeypatch):
    """The whole layer, routed against dense: output, aux loss and router
    probabilities, and the gradients of x and every parameter."""
    layer = _layer(e=8)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 21, D, generator=gen)
    cot = torch.randn(2, 21, D, generator=gen)
    got = {}
    for path, min_rows in (("routed", 0), ("dense", 10 ** 9)):
        monkeypatch.setattr(moe, "ROUTED_MIN_ROWS", min_rows)
        x_ = x.clone().requires_grad_(True)
        routed, _ = _counts()
        out, aux, probs = layer(x_)
        assert (_counts()[0] > routed) == (path == "routed")
        params = list(layer.parameters())
        grads = torch.autograd.grad(torch.sum(out * cot) + aux, [x_] + params)
        got[path] = (out.detach(), aux.detach(), probs.detach(), grads)
    (out, aux, probs, grads), (want, want_aux, want_probs, want_grads) = got["routed"], got["dense"]
    _close(out, want, "output")
    assert torch.equal(aux, want_aux) and torch.equal(probs, want_probs)
    names = ["x"] + [n for n, _ in layer.named_parameters()]
    for g, w, name in zip(grads, want_grads, names):
        _close(g, w, name)


def test_path_choice_follows_the_mean_rows_an_expert(monkeypatch):
    monkeypatch.setattr(moe, "ROUTED_MIN_ROWS", 4)
    layer = _layer(e=4, k=2)  # routed from T * 2 / 4 >= 4, T >= 8
    assert _took(layer, torch.randn(2, 4, D)) == "routed"  # at the constant
    assert _took(layer, torch.randn(1, 9, D)) == "routed"  # above
    assert _took(layer, torch.randn(1, 7, D)) == "dense"  # below
    with torch.no_grad():  # the choice does not depend on autograd
        assert _took(layer, torch.randn(1, 8, D)) == "routed"


def test_path_choice_keeps_dense_where_the_routed_path_cannot_run(monkeypatch):
    monkeypatch.setattr(moe, "ROUTED_MIN_ROWS", 0)
    # an int8 bank
    assert _took(_layer(quantized=True), torch.randn(1, 8, D)) == "dense"
    layer = _layer()
    big = SimpleNamespace(shape=(1, 8, D), is_cuda=True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert layer._routed(big, split=False)
    # a bank split over an expert axis, and one split over a model axis
    assert not layer._routed(big, split=True)
    layer.experts.tp_group = object()
    assert not layer._routed(big, split=False)
    layer.experts.tp_group = None
    # a CUDA stream capturing a graph (the pooled decode)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert not layer._routed(big, split=False)
    # capture is a CUDA stream's: a CPU tensor does not ask for it
    assert layer._routed(SimpleNamespace(shape=(1, 8, D), is_cuda=False), split=False)
    # other dispatches never count
    cap = _layer(dispatch="capacity")
    before = _counts()
    cap(torch.randn(1, 8, D))
    assert _counts() == before


def test_the_default_constant_keeps_short_prompts_dense():
    """At the LM's 8 experts top-2, a prompt of 1,536 tokens (384 rows an
    expert, the serving cell's longest) stays below the constant, and the
    training cell's 8 x 2,048 tokens (4,096 rows an expert) reach it."""
    assert 1536 * 2 / 8 < moe.ROUTED_MIN_ROWS <= 8 * 2048 * 2 / 8


def test_train_step_routed_matches_jax(monkeypatch):
    """One LM training step on the routed path against the JAX package's
    dense-dispatch step, held as the dense step is."""
    import test_torch_lm_train

    monkeypatch.setattr(moe, "ROUTED_MIN_ROWS", 0)
    routed, dense = _counts()
    test_torch_lm_train.test_train_step_matches_jax("dense")
    after = _counts()
    assert after[0] > routed and after[1] == dense
