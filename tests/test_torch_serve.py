"""The port's serving path (repro_torch.launch) against the reference's
on the reduced gemma3-1b, the five decoders ported with it (granite-3-2b,
chatglm3-6b, granite-20b, granite-moe-1b-a400m, mixtral-8x7b) and the
VLM and encoder-decoder (llama-3.2-vision-11b, seamless-m4t-medium), and
the port's isolation from the JAX package.

Serve: prefill with ``cache_len`` at its default, so every decode buffer
is ``prompt_len`` wide (the reference's quirk, which the port keeps), then
decode past ``prompt_len`` teacher-forced on the reference's tokens. The
VLM and the encoder-decoder take the launcher's context (image patches,
or frames encoded again for every step), and their cross-attention gates
are set to GATE on both sides: at init (0) the cross layers are no-ops."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import encode as jencode  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import transformer as tm  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = dict(rtol=2e-2, atol=2e-2)
MARGIN = 4e-2   # greedy tokens must agree where the reference's top-2 gap exceeds this
BATCH, PROMPT, DECODE = 2, 5, 8
NEW_ARCHS = ("granite-3-2b", "chatglm3-6b", "granite-20b",
             "granite-moe-1b-a400m", "mixtral-8x7b")
CTX_ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-medium")
GATE = 0.5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _agree_where_decisive(ref_logits, ref_ids, ids):
    top2 = np.sort(ref_logits, axis=-1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > MARGIN
    np.testing.assert_array_equal(ids[decisive], ref_ids[decisive])


def test_prompts_match_reference():
    cfg = get_reduced("gemma3-1b")
    want = JSyntheticLM(vocab=cfg.vocab, seed=1).batch(0, 0, 3, 7)["tokens"]
    np.testing.assert_array_equal(serve.prompts(cfg, 3, 7, "cpu").numpy(),
                                  want)


def _gated(tree, cfg):
    """The numpy params tree with every cross-attention gate at GATE."""
    periods = {k: dict(v, gate=np.full(v["gate"].shape, GATE,
                                       ml_dtypes.bfloat16))
               if "gate" in v else v for k, v in tree["periods"].items()}
    return dict(tree, periods=periods)


def _serve_steps_match_reference_past_prompt_len(arch):
    jcfg = jget_reduced(arch)
    cfg = get_reduced(arch)
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    if arch in CTX_ARCHS:
        tree = _gated(tree, cfg)
    params_j = jax.tree.map(jnp.asarray, tree)
    params_t = bridge.params_from_numpy(tree, cfg, device="cpu")
    prompts = serve.prompts(cfg, BATCH, PROMPT, "cpu")
    # the launcher's context, the same bits on both sides (test_torch_vlm)
    ctx_t = serve.context(cfg, BATCH, "cpu")
    ctx_j = () if ctx_t is None else (jnp.asarray(
        ctx_t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)),)

    ref_prefill = jax.jit(jsteps.make_prefill_step(jcfg))
    ref_serve = jax.jit(jsteps.make_serve_step(jcfg))
    ref_decode = jax.jit(lambda p, t, c, *x: jdecode_step(p, jcfg, t, c, *x))
    port_serve = steps.make_serve_step(cfg)
    # what decode_tokens hands each step: frames encoded anew, or patches
    dec_j = tuple(jencode(params_j, jcfg, x) if jcfg.is_encdec else x
                  for x in ctx_j)
    dec_t = steps.model_context(params_t, cfg, ctx_t)

    lj, cj = ref_prefill(params_j, jnp.asarray(prompts.numpy()), *ctx_j)
    lt, ct = steps.make_prefill_step(cfg)(params_t, prompts, ctx_t)
    assert lt.shape == lj.shape == (BATCH, 1, cfg.vocab)
    np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
    # the quirk: every layer's buffer is prompt_len wide, globals included;
    # cross-attention layers keep no cache
    for j, mixer in enumerate(cfg.layer_pattern):
        for cache in (ct, cj):
            layer = cache["periods"][f"l{j}"]
            if mixer == "cross":
                assert layer == {}
            else:
                assert layer["k"].shape[3] == PROMPT

    tok_j = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)[:, None]
    _agree_where_decisive(_np(lj[:, -1]), np.asarray(tok_j[:, 0]),
                          _np(lt[:, -1]).argmax(-1))
    for _ in range(DECODE):       # positions PROMPT .. PROMPT+DECODE-1 wrap
        tok_t = torch.tensor(np.asarray(tok_j))
        logits_j, cj_next = ref_decode(params_j, tok_j, cj, *dec_j)
        logits_t, ct_next = tm.decode_step(params_t, cfg, tok_t, ct, dec_t)
        np.testing.assert_allclose(_np(logits_t), _np(logits_j), **TOL)
        # serve_step from the same cache: rewrites the same slot, idempotent
        ids_j, _ = ref_serve(params_j, tok_j, cj, *dec_j)
        ids_t, _ = port_serve(params_t, tok_t, ct, dec_t)
        _agree_where_decisive(_np(logits_j[:, 0]), np.asarray(ids_j[:, 0]),
                              ids_t[:, 0].numpy())
        tok_j, cj, ct = ids_j, cj_next, ct_next
    assert ct["t"].tolist() == [PROMPT + DECODE] * BATCH


def test_serve_steps_match_reference_past_prompt_len():
    _serve_steps_match_reference_past_prompt_len("gemma3-1b")


@pytest.mark.parametrize("arch", NEW_ARCHS + CTX_ARCHS)
def test_new_arch_serve_steps_match_reference_past_prompt_len(arch):
    _serve_steps_match_reference_past_prompt_len(arch)


@pytest.mark.parametrize("arch", CTX_ARCHS)
def test_decode_tokens_threads_the_context_as_the_reference(arch):
    """``decode_tokens``, which encodes the frames again for every step of
    the encoder-decoder, gives the reference's first token where its
    top-2 gap is decisive, then from the same token the reference's
    DECODE greedy tokens (gates at GATE)."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    tree = _gated(jax.tree.map(np.asarray,
                               jinit_params(jcfg, jax.random.PRNGKey(0))), cfg)
    params_j = jax.tree.map(jnp.asarray, tree)
    params_t = bridge.params_from_numpy(tree, cfg, device="cpu")
    prompts = serve.prompts(cfg, BATCH, PROMPT, "cpu")
    ctx_t = serve.context(cfg, BATCH, "cpu")
    ctx_j = jnp.asarray(ctx_t.view(torch.int16).numpy().view(
        ml_dtypes.bfloat16))
    lj, cj = jax.jit(jsteps.make_prefill_step(jcfg))(
        params_j, jnp.asarray(prompts.numpy()), ctx_j)
    tok_j = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)[:, None]
    tok_t, _, ct, _ = serve.run_prefill(cfg, params_t, prompts, ctx_t)
    _agree_where_decisive(_np(lj[:, -1]), np.asarray(tok_j[:, 0]),
                          tok_t[:, 0].numpy())
    want, _ = jserve.decode_tokens(jcfg, jax.jit(jsteps.make_serve_step(jcfg)),
                                   params_j, tok_j, cj, ctx_j, DECODE)
    got, ct = serve.decode_tokens(cfg, steps.make_serve_step(cfg), params_t,
                                  torch.tensor(np.asarray(tok_j)), ct, ctx_t,
                                  DECODE)
    assert len(got) == DECODE and ct["t"].tolist() == [PROMPT + DECODE] * BATCH
    assert np.array_equal(np.concatenate([np.asarray(t) for t in want], 1),
                          torch.cat(got, 1).numpy())


def test_main_runs_on_cpu(capsys):
    serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--decode", "3"])
    out = capsys.readouterr().out
    assert "decoded 3 tokens" in out and "on cpu" in out


@pytest.mark.parametrize("arch", NEW_ARCHS + CTX_ARCHS)
def test_main_runs_every_new_arch_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "4", "--decode", "3"])
    out = capsys.readouterr().out
    assert "decoded 3 tokens" in out and "on cpu" in out


# ------------------------------------------------------------- no fallback

def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("gemma3-1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced"])


# --------------------------------------------------------------- isolation

def test_port_imports_no_jax_and_nothing_of_repro():
    code = ("import sys, repro_torch.launch.serve, repro_torch.bridge, "
            "repro_torch.core, repro_torch.configs.paper_workloads, "
            "repro_torch.kernels.ops, repro_torch.models.moe\n"
            "from repro_torch.configs import ARCH_IDS, get_config\n"
            "[get_config(a) for a in ARCH_IDS]\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _port_sources():
    base = os.path.join(ROOT, "src", "repro_torch")
    for d, _, files in os.walk(base):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_import_no_jax_or_repro():
    def banned(mod):
        top = (mod or "").split(".")[0]
        return top in ("jax", "jaxlib", "ml_dtypes", "repro")
    found = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                found += [(path, a.name) for a in node.names if banned(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and banned(node.module):
                found.append((path, node.module))
    assert not found, found
