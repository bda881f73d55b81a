"""The port's serving entry: ``launch/serve.py``'s class, sampling and
checkpoint flags, and grouped kv heads at minitron-4b's G = 3.

The launcher on the CPU at reduced size: ``--batch-frac`` / ``--deadline-ms``
print a line per latency class whose counts add up to the stream,
``--temperature`` samples, both together on a pool below capacity
preempt and still finish everything.  ``--ckpt-dir`` serves what
``launch/train.py --ckpt-dir`` saved: the tokens equal an engine given the
restored parameters directly and differ from the random-init run, and an
empty directory serves the random parameters.  Grouped kv heads: the plain
paged attention at minitron-4b's 24 query heads over 8 kv heads of 128
against the JAX oracle, and reduced minitron-4b widened to G = 3 (6 heads
over 2) through the port's engine (prefix caching on and off, the slab)
token-identical to JAX's.  Inputs come from numpy seeds."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch import trace_serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

CLASS_LINE = re.compile(r"\[serve\] class (\w+) \(w=(\d+)\): finished=(\d+)/(\d+), "
                        r"tokens=(\d+), preemptions=(\d+), slo_violations=(\d+), "
                        r"ttft_p50=")


# ---------------------------------------------------------------------------
# the launcher's class and sampling flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--batch-frac", "0.5", "--deadline-ms", "1e6"],
    ["--temperature", "0.8"],
    ["--batch-frac", "0.5", "--deadline-ms", "1e6", "--temperature", "0.8",
     "--num-blocks", "8", "--max-new-tokens", "40", "--preempt-policy", "swap"]],
    ids=["classes", "temperature", "both-pressured"])
def test_launch_serve_classes_and_sampling(capsys, flags):
    """Every request finishes; one line per class served, their finished
    and submitted counts equal and summing to the stream, their tokens to
    the summary's; a batch request decodes twice the new tokens; the
    deadline line counts no violation at 1e6 ms; the pressured run
    preempts."""
    tlaunch.main(["--reduced", "--device", "cpu"] + flags)
    out = capsys.readouterr().out
    summary = [ln for ln in out.splitlines() if "tok/s" in ln][-1]
    n_req, n_tok = map(int, re.match(r"\[serve\] (\d+) requests, (\d+) tokens",
                                     summary).groups())
    classes = {m[0]: [int(x) for x in m[1:]] for m in CLASS_LINE.findall(out)}
    assert n_req == 8 and sum(c[2] for c in classes.values()) == n_req
    assert all(c[1] == c[2] for c in classes.values())
    assert sum(c[3] for c in classes.values()) == n_tok
    new = 40 if "--max-new-tokens" in flags else 16
    if "--batch-frac" in flags:
        assert set(classes) == {"interactive", "batch"}
        assert classes["interactive"][0] == 8 and classes["batch"][0] == 1
        assert classes["batch"][3] == 2 * new * classes["batch"][2]
        assert classes["interactive"][3] == new * classes["interactive"][2]
        assert "[serve] slo: interactive deadline 1e+06ms (batch 1e+07ms): " \
               "0 of 8 finished requests violated" in out
    else:
        assert set(classes) == {"interactive"} and n_tok == 8 * new
    if "--num-blocks" in flags:
        n = int(summary.split("preemptions=")[1].split(" ")[0])
        assert n >= 1 and sum(c[4] for c in classes.values()) == n


# ---------------------------------------------------------------------------
# --ckpt-dir
# ---------------------------------------------------------------------------

class _Recorder(TEngine):
    """The launcher's engine, kept with what it was given and asked."""
    seen = []

    def __init__(self, cfg, params, **kw):
        super().__init__(cfg, params, **kw)
        self.kw, self.subs = kw, []
        _Recorder.seen.append(self)

    def submit(self, prompt, **kw):
        self.subs.append((list(prompt), kw))
        return super().submit(prompt, **kw)


def _serve(monkeypatch, capsys, *extra):
    """The launcher's run on reduced granite-3-2b: (engine, tokens by
    submission, stdout)."""
    _Recorder.seen = []
    monkeypatch.setattr(tlaunch, "ServeEngine", _Recorder)
    tlaunch.main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                  "--requests", "4", "--max-new-tokens", "8", *extra])
    (eng,) = _Recorder.seen
    toks = [eng._reqs[i].out_tokens for i in range(len(eng.subs))]
    return eng, toks, capsys.readouterr().out


def test_launch_serve_ckpt_dir(tmp_path, monkeypatch, capsys):
    ckpt = tmp_path / "ckpt"
    # base lr 1 under the 100-step warmup: steps of 0.01-0.03, enough to
    # move the greedy tokens
    ttrain.main(["--reduced", "--device", "cpu", "--steps", "3", "--lr", "1.0",
                 "--ckpt-dir", str(ckpt), "--seq-len", "16", "--global-batch", "2"])
    capsys.readouterr()
    eng, got, out = _serve(monkeypatch, capsys, "--ckpt-dir", str(ckpt))
    assert f"[serve] restored step 2 from {ckpt}" in out
    cfg = t_reduced(t_get_config("granite-3-2b"))
    step, state = CheckpointManager(str(ckpt)).restore(
        tstep.init_state(cfg, 0, device="cpu"))
    assert step == 2
    direct = TEngine(cfg, state.params, **eng.kw)
    rids = [direct.submit(p, **kw) for p, kw in eng.subs]
    direct.run_until_drained()
    assert got == [direct._reqs[r].out_tokens for r in rids]
    _, rand, out_rand = _serve(monkeypatch, capsys)
    assert "restored step" not in out_rand and rand != got
    empty = tmp_path / "empty"
    empty.mkdir()
    _, from_empty, out_empty = _serve(monkeypatch, capsys, "--ckpt-dir", str(empty))
    assert "restored step" not in out_empty and from_empty == rand


# ---------------------------------------------------------------------------
# grouped kv heads, G = 3
# ---------------------------------------------------------------------------

def test_gqa_plain_attention_matches_jax_oracle():
    """The plain paged decode and prefill at minitron-4b's heads (24 over 8,
    head dim 128) against the JAX oracle in f32; a version that reads q
    head h against kv head h mod 8 instead of h // 3 is far off."""
    cfg = t_get_config("minitron-4b")
    h, kvh, d, bs = cfg.n_heads, cfg.n_kv_heads, cfg.hd, 8
    assert (h, kvh, d) == (24, 8, 128)
    rng = np.random.default_rng(7)
    nb, mb, b = 20, 4, 3
    kp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    vp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    tables = (rng.permutation(nb - 1)[:b * mb] + 1).reshape(b, mb).astype(np.int32)
    lens = np.array([1, 17, 32], np.int32)
    qd = rng.normal(size=(b, h, d)).astype(np.float32)
    t = torch.from_numpy
    got = ref.paged_decode_attention(t(qd), t(kp), t(vp), t(tables), lengths=t(lens))
    want = jref.paged_decode_attention(qd, kp, vp, tables, lengths=lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    wrong = np.arange(h) % kvh
    bad = ref.paged_decode_attention(t(qd), t(kp[wrong]), t(vp[wrong]), t(tables),
                                     lengths=t(lens))
    assert float((bad - got).abs().max()) > 0.1
    qp = rng.normal(size=(1, 11, h, d)).astype(np.float32)
    kw = dict(q_offset=13, length=11)
    got = ref.paged_prefill_attention(t(qp), t(kp), t(vp), t(tables[0]), **kw)
    want = jref.paged_prefill_attention(qp, kp, vp, tables[0], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def gqa3():
    """Reduced minitron-4b widened to 6 query heads over 2 kv heads
    (G = 3, minitron-4b's group), fp32: (port cfg, JAX cfg, JAX params,
    port params)."""
    over = dict(n_heads=6, n_kv_heads=2)
    cfg = reduced(get_config("minitron-4b")).replace(**over)
    jp = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    return (t_reduced(t_get_config("minitron-4b")).replace(**over), cfg, jp,
            params_from_jax(jax.tree.map(np.asarray, jp)))


@pytest.mark.parametrize("opts", [{}, dict(prefix_caching=False), dict(paged=False)],
                         ids=["runner", "cache-off", "slab"])
def test_gqa3_engine_matches_jax(gqa3, opts):
    """A shared-prefix pair and prompts crossing chunk boundaries through
    the port's engine at G = 3, token-identical to JAX's engine; the
    runner with caching on hits the prefix."""
    tcfg, cfg, jp, tp = gqa3
    assert tcfg.n_heads // tcfg.n_kv_heads == 3
    rng = np.random.default_rng(9)
    shared = rng.integers(0, tcfg.vocab_size, 24).tolist()
    prompts = [shared + rng.integers(0, tcfg.vocab_size, 5).tolist(),
               rng.integers(0, tcfg.vocab_size, 40).tolist(),
               rng.integers(0, tcfg.vocab_size, 9).tolist(),
               shared + rng.integers(0, tcfg.vocab_size, 7).tolist()]
    kw = dict(max_seq=96, slots=2, block_size=8, prefill_buckets=(16, 32), **opts)
    outs = []
    for eng in (JEngine(cfg, jp, **kw), TEngine(tcfg, tp, **kw)):
        rids = [eng.submit(p, max_new_tokens=10) for p in prompts]
        done = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        outs.append(([done[r] for r in rids], dict(eng.stats)))
    (want, jst), (got, tst) = outs
    assert got == want
    for k in ("prefill_dispatches", "decode_tokens", "prefix_hit_tokens"):
        assert tst[k] == jst[k], k
    if not opts:
        assert tst["prefix_hit_tokens"] > 0


def test_trace_serve_ranges_the_lm_head():
    """trace_serve puts ``model._logits`` (the final norm and the
    vocabulary-wide GEMM) under the "LM head" range, moving its GEMMs and
    other ops there, its rmsnorm left with the port's kernels."""
    assert (TM, "_logits", "LM head") in trace_serve.RANGED
    assert trace_serve.MOVED_FROM["LM head"] == (trace_serve.OTHER_OPS,
                                                 trace_serve.GEMMS)
    assert trace_serve._group("rmsnorm_kernel<float>") != trace_serve.GEMMS
