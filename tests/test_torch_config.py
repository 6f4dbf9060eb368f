"""The port's recipe registry (cosyvoice_tpu_torch/config.py) against the
JAX package's (cosyvoice_tpu/config.py) over every example recipe under
examples/tts_vc/*/conf: the YAML reader equals yaml.safe_load; every
{yaml, section} builds in the port on the meta device; its config equals
the JAX one field by field (the JAX-only fields, XLA and TPU switches,
left at their defaults by every recipe); and the port module's parameter
names and shapes equal the JAX `jax.eval_shape(model.init, ...)` tree as
the port's converter carries it.  Sections with equal JAX configs are
traced once on the JAX side (a full-width trace each)."""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu import config as jconfig
from cosyvoice_tpu_torch import config as tconfig
from cosyvoice_tpu_torch import convert

ROOT = os.path.join(os.path.dirname(__file__), "..", "examples", "tts_vc")
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "*", "conf", "*.yaml")))


def _groups() -> list:
    """[(kind, [(path, section), ...])] for each distinct JAX config of a
    model section (sections that differ only in comments, key order or
    training-only keys share one)."""
    groups: dict = {}
    for path in CONFIGS:
        for sec, conf in yaml.safe_load(open(path)).items():
            if isinstance(conf, dict) and "kind" in conf:
                conf = dict(conf)
                kind = conf.pop("kind")
                key = (kind, jconfig.build_model(kind, conf)[1])
                groups.setdefault(key, []).append((path, sec))
    return [(kind, where) for (kind, _), where in groups.items()]


GROUPS = _groups()
KEY = jax.random.PRNGKey(0)

CONVERT = {
    "qwen2lm": lambda p, cfg: convert.lm_state_from_jax(p),
    "transformer_lm": lambda p, cfg: convert.transformer_lm_state_from_jax(p),
    "transformer_lm_phoneme": lambda p, cfg: convert.v1_phoneme_lm_state_from_jax(p),
    "qwen2lm_phoneme_src2": lambda p, cfg: convert.phoneme_lm_state_from_jax(p),
    "qwen2lm_phoneme_multicode": lambda p, cfg: convert.multicode_lm_state_from_jax(p),
    "flow": lambda p, cfg: convert.flow_state_from_jax(p),
    "flow_v1": lambda p, cfg: convert.flow_v1_state_from_jax(p),
    "hift": lambda p, cfg: convert.hift_state_from_jax(p),
    "bigvgan": lambda p, cfg: convert.bigvgan_state_from_jax(p, cfg),
    "vits": lambda p, cfg: convert.vits_state_from_jax(p),
    "speaker_embedding": lambda p, cfg: convert.speaker_embedding_state_from_jax(p),
}


def _jax_shapes(kind: str, model, cfg):
    """The variables' shapes of model.init through the call each recipe
    test of the JAX package makes (tests/test_example_configs.py)."""
    if kind.startswith(("qwen2lm", "transformer_lm")):
        text, pho = jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8, 4), jnp.int32)
        st = jnp.zeros((1, 10, cfg.codebooknum) if hasattr(cfg, "codebooknum") else (1, 10),
                       jnp.int32)
        l1, l2 = jnp.asarray([8]), jnp.asarray([10])
        emb = jnp.zeros((1, getattr(cfg, "spk_embed_dim", 192)))
        args = {"qwen2lm": (text, l1, st, l2), "transformer_lm": (text, l1, st, l2, emb),
                "transformer_lm_phoneme": (pho, l1, st, l2, emb)}.get(
            kind, (text, l1, pho, l1, st, l2, emb))
        return jax.eval_shape(lambda: model.init(KEY, *args))
    if kind in ("flow", "flow_v1"):
        return jax.eval_shape(lambda: model.init(
            {"params": KEY, "dropout": KEY}, jnp.zeros((1, 10), jnp.int32), jnp.asarray([10]),
            jnp.zeros((1, 20, cfg.output_size)), jnp.asarray([20]),
            jnp.zeros((1, cfg.spk_embed_dim)), KEY))
    if kind == "hift":
        return jax.eval_shape(lambda: model.init({"params": KEY, "noise": KEY},
                                                 jnp.zeros((1, 12, cfg.in_channels))))
    if kind == "bigvgan":
        return jax.eval_shape(lambda: model.init(
            KEY, jnp.zeros((1, 12), jnp.int32), jnp.asarray([12]),
            jnp.zeros((1, cfg.speaker_embedding_dim))))
    if kind == "vits":
        return jax.eval_shape(lambda: model.init(
            KEY, jnp.zeros((1, 12), jnp.int32), jnp.asarray([12]),
            jnp.zeros((1, 40, cfg.spec_channels)), jnp.asarray([40]),
            jnp.zeros((1, cfg.gin_channels)), KEY))
    assert kind == "speaker_embedding", kind
    return jax.eval_shape(lambda: model.init(
        KEY, jnp.zeros((1, 50, 80)), jnp.zeros((1, 40, cfg.spec_channels)),
        jnp.asarray([40]), KEY))


def _same_config(port, jax_cfg, path: str) -> None:
    """Every port field equals the JAX one (recursing into nested configs);
    every JAX-only field holds its default."""
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(got):
            _same_config(got, want, f"{path}.{f.name}")
        else:
            assert got == want, f"{path}.{f.name}: {got!r} != {want!r}"
    names = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(jax_cfg):
        if f.name not in names:
            default = (f.default if f.default is not dataclasses.MISSING
                       else f.default_factory())
            assert getattr(jax_cfg, f.name) == default, f"{path}.{f.name} is set"


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_yaml_reader_matches_safe_load(path):
    assert tconfig.load_config(path) == yaml.safe_load(open(path))


@pytest.mark.parametrize("kind,where", GROUPS,
                         ids=[f"{os.path.basename(w[0][0])}:{w[0][1]}" for _, w in GROUPS])
def test_recipe_builds_in_port(kind, where, monkeypatch):
    """Each {yaml, section} of this content builds in the port on meta with
    the JAX package's config; the port's parameter names and shapes are the
    JAX init tree's, carried by the kind's converter (leaves stand in as
    zero-stride arrays and come out as meta tensors: nothing is allocated)."""
    path, sec = where[0]
    jmodel, jcfg = jconfig.build_from_yaml(path, sec)
    for p, s in where:
        tmodel, tcfg = tconfig.build_from_yaml(p, s, device="meta")
        _same_config(tcfg, jcfg, f"{os.path.basename(p)}:{s}")
    shapes = _jax_shapes(kind, jmodel, jcfg)
    stand_in = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32 if s.dtype == jnp.bfloat16
                                           else s.dtype), s.shape), shapes)
    monkeypatch.setattr(convert, "_t", lambda x: torch.empty(np.shape(x), device="meta"))
    carried = CONVERT[kind](stand_in, tcfg)
    port = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in carried.items()} == port
    assert all(v.is_meta for v in tmodel.state_dict().values())


def test_unknown_key_raises():
    with pytest.raises(KeyError):
        tconfig.build_model("hift", {"nonexistent_field": 1})
    with pytest.raises(KeyError):
        tconfig.build_model("qwen2lm", {"qwen": {"hidden": 8}})
    assert len(tconfig._registry()[0]) == len(jconfig._registry()[0]) == 17
    assert set(tconfig._registry()[0]) == set(jconfig._registry()[0])


# Each YAML form the recipe reader once read apart from yaml.safe_load
# (ROADMAP Queue 3 F1), and its neighbours: block scalars, quote escapes,
# tags, YAML 1.1 ints and floats, case-exact booleans.
F1_FORMS = {
    "literal": "a: |\n  hi\n  there\n\n  x\nb: 1\n",
    "literal_strip": "a: |-\n  hi\n",
    "literal_keep": "a: |+\n  x\n\nb: 1\n",
    "literal_comment_text": "a: |\n  # not a comment\n  x\n",
    "folded": "a: >\n  hi\n  there\n\n  x\nb: 1\n",
    "folded_nested": "a:\n  b: >-\n    one\n    two\n  c: 3\n",
    "single_quote_escape": "a: 'it''s'",
    "double_quote_escape": 'a: "x\\ty\\"z"',
    "tag_float": "a: !!float 1",
    "tag_int_octal": "a: !!int 010",
    "tag_str": "a: !!str 1",
    "hex": "a: 0x10",
    "octal": "a: 010",
    "binary": "a: 0b101",
    "base60": "a: 1:20",
    "inf": "a: .inf",
    "minus_inf": "a: -.inf",
    "dot_float": "a: .5",
    "signed_dot_string": "a: -.5",
    "exponent_without_sign_string": "a: 1.0e3",
    "exponent": "a: 1.0e+3",
    "mixed_case_bool_string": "a: tRUE",
    "flow_quoted": "a: ['x, y', 'it''s', \"q\\\"\"]",
}
F1_REFUSED = {
    "timestamp": "a: 2001-12-14",
    "anchor": "a: &x 1",
    "alias": "a: *x",
    "multi_line_plain": "a: hello\n  world\n",
    "multi_line_flow": "a: [1,\n 2]\n",
    "document_marker": "---\na: 1\n",
    "local_tag": "a: !foo 1",
    "folded_more_indented": "a: >\n  x\n    y\n",
}


@pytest.mark.parametrize("text", list(F1_FORMS.values()), ids=list(F1_FORMS))
def test_yaml_reader_forms_match_safe_load(text):
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", list(F1_REFUSED.values()), ids=list(F1_REFUSED))
def test_yaml_reader_refuses_what_it_does_not_read(text):
    """safe_load reads these (or fails on them); the reader raises rather
    than read them some other way."""
    with pytest.raises(ValueError):
        tconfig.parse_yaml(text)
