"""Typed configs from the example recipes: YAML -> config dataclasses ->
the port's models.

Port of cosyvoice_tpu/config.py: the same 17 model kinds and the same map
of nested config fields, over the port's classes.  `build_model(kind,
overrides, device)` builds the config dataclass from a dict (an unknown key
raises KeyError; lists become tuples) and constructs the module, under
`device` when one is given (torch.device("meta") builds a full-width model
without memory).  The recipes' training-only keys (dropout rates, loss
settings) are fields of the port's configs that no inference code reads.

The recipes are read by a small YAML reader of the subset they use (block
mappings by indentation, flow lists and mappings, block sequences of those,
plain and quoted scalars, comments; anything else raises), so the port
needs no YAML package;
tests/test_torch_config.py holds it equal to yaml.safe_load on every
recipe.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Optional

import torch

RECIPES = Path(__file__).resolve().parents[1] / "examples" / "tts_vc"


def _mk(cls, d: Optional[dict]):
    """Build dataclass `cls` from dict `d`, recursing into the mapped
    sub-config fields (unknown keys raise KeyError)."""
    if d is None:
        return cls()
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"{cls.__name__} has no field '{k}'")
        sub = _registry()[1].get((cls.__name__, k))
        if sub is not None and isinstance(v, dict):
            kw[k] = _mk(sub, v)
        elif isinstance(v, list):
            kw[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        else:
            kw[k] = v
    return cls(**kw)


_REGISTRY: tuple = ()


def _registry() -> tuple:
    """(kind -> (module class, config class), (config class name, field) ->
    nested config class), built on first use."""
    global _REGISTRY
    if _REGISTRY:
        return _REGISTRY
    from cosyvoice_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from cosyvoice_tpu_torch.models.campplus import CAMPPlus, CAMPPlusConfig
    from cosyvoice_tpu_torch.models.conformer import ConformerConfig
    from cosyvoice_tpu_torch.models.flow import (CausalMaskedDiffWithXvec, CFMConfig,
                                                 EstimatorConfig, FlowConfig, FlowV1Config,
                                                 MaskedDiffWithXvec)
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import (LMConfig, Qwen2LM, SamplingConfig,
                                                TransformerLM, TransformerLMConfig)
    from cosyvoice_tpu_torch.models.llm_multicode import (MultiCodeLMConfig,
                                                          Qwen2LMPhonemeMultiCode)
    from cosyvoice_tpu_torch.models.llm_phoneme import (PhonemeEmbedConfig, PhonemeLMConfig,
                                                        Qwen2LMPhoneme, Qwen2LMPhonemeSrc,
                                                        Qwen2LMPhonemeSrc2)
    from cosyvoice_tpu_torch.models.llm_v1_phoneme import (TransformerLMPhoneme,
                                                           TransformerLMPhonemeWithSpk,
                                                           V1PhonemeLMConfig, WithSpkConfig)
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.models.s3tokenizer import S3Config, S3TokenizerV2
    from cosyvoice_tpu_torch.models.speaker import SpeakerEmbedding, SpeakerEmbeddingConfig
    from cosyvoice_tpu_torch.models.vits import VitsConfig, VitsDecoder

    models = {
        "qwen2lm": (Qwen2LM, LMConfig),
        "transformer_lm": (TransformerLM, TransformerLMConfig),
        "transformer_lm_phoneme": (TransformerLMPhoneme, V1PhonemeLMConfig),
        "transformer_lm_phoneme_with_spk": (TransformerLMPhonemeWithSpk, WithSpkConfig),
        "qwen2lm_phoneme": (Qwen2LMPhoneme, PhonemeLMConfig),
        "qwen2lm_phoneme_src": (Qwen2LMPhonemeSrc, PhonemeLMConfig),
        "qwen2lm_phoneme_src2": (Qwen2LMPhonemeSrc2, PhonemeLMConfig),
        "qwen2lm_phoneme_multicode": (Qwen2LMPhonemeMultiCode, MultiCodeLMConfig),
        "flow": (CausalMaskedDiffWithXvec, FlowConfig),
        # the stream family: the same module, its estimator's `stream` flag
        # set in the recipe (the JAX package's StreamMaskedDiffWithXvec adds
        # nothing to its base class)
        "flow_stream": (CausalMaskedDiffWithXvec, FlowConfig),
        "flow_v1": (MaskedDiffWithXvec, FlowV1Config),
        "hift": (HiFTGenerator, HiFTConfig),
        "bigvgan": (BigVGAN, BigVGANConfig),
        "vits": (VitsDecoder, VitsConfig),
        "campplus": (CAMPPlus, CAMPPlusConfig),
        "speaker_embedding": (SpeakerEmbedding, SpeakerEmbeddingConfig),
        "s3tokenizer": (S3TokenizerV2, S3Config),
    }
    sub = {
        ("LMConfig", "qwen"): Qwen2Config,
        ("LMConfig", "sampling"): SamplingConfig,
        ("TransformerLMConfig", "sampling"): SamplingConfig,
        ("TransformerLMConfig", "text_encoder"): ConformerConfig,
        ("TransformerLMConfig", "llm"): ConformerConfig,
        ("WithSpkConfig", "lm"): V1PhonemeLMConfig,
        ("WithSpkConfig", "spk"): SpeakerEmbeddingConfig,
        ("V1PhonemeLMConfig", "sampling"): SamplingConfig,
        ("V1PhonemeLMConfig", "text_encoder"): ConformerConfig,
        ("V1PhonemeLMConfig", "llm"): ConformerConfig,
        ("V1PhonemeLMConfig", "phoneme"): PhonemeEmbedConfig,
        ("PhonemeLMConfig", "sampling"): SamplingConfig,
        ("PhonemeLMConfig", "phoneme"): PhonemeEmbedConfig,
        ("PhonemeLMConfig", "encoder"): ConformerConfig,
        ("PhonemeLMConfig", "qwen"): Qwen2Config,
        ("MultiCodeLMConfig", "sampling"): SamplingConfig,
        ("MultiCodeLMConfig", "phoneme"): PhonemeEmbedConfig,
        ("MultiCodeLMConfig", "encoder"): ConformerConfig,
        ("MultiCodeLMConfig", "qwen"): Qwen2Config,
        ("FlowConfig", "encoder"): ConformerConfig,
        ("FlowConfig", "cfm"): CFMConfig,
        ("FlowConfig", "estimator"): EstimatorConfig,
        ("FlowV1Config", "encoder"): ConformerConfig,
        ("FlowV1Config", "cfm"): CFMConfig,
        ("FlowV1Config", "estimator"): EstimatorConfig,
        ("BigVGANConfig", "encoder1"): ConformerConfig,
        ("BigVGANConfig", "encoder2"): ConformerConfig,
        ("VitsConfig", "up_enc1"): ConformerConfig,
        ("VitsConfig", "up_enc2"): ConformerConfig,
        ("SpeakerEmbeddingConfig", "campplus"): CAMPPlusConfig,
    }
    _REGISTRY = (models, sub)
    return _REGISTRY


def make_config(kind: str, overrides: Optional[dict] = None):
    """The config dataclass of `kind` from a dict of its fields."""
    return _mk(_registry()[0][kind][1], overrides)


def build_model(kind: str, overrides: Optional[dict] = None, device=None):
    """('qwen2lm', {...}) -> (module, config dataclass); the module is built
    under `device` when one is given (its parameters' initial values are
    the constructors' random ones: load weights into it)."""
    cls = _registry()[0][kind][0]
    cfg = make_config(kind, overrides)
    if device is None:
        return cls(cfg), cfg
    with torch.device(device):
        return cls(cfg), cfg


def load_config(path) -> dict:
    with open(path) as f:
        return parse_yaml(f.read())


def build_from_yaml(path, section: str, device=None):
    """YAML layout: {section: {kind: ..., <config fields>}} -> (module, config)."""
    conf = dict(load_config(path)[section])
    kind = conf.pop("kind")
    return build_model(kind, conf, device)


def recipe_config(recipe: str, section: str):
    """The config dataclass of `section` in examples/tts_vc/<recipe>."""
    conf = dict(load_config(RECIPES / recipe)[section])
    return make_config(conf.pop("kind"), conf)


# ---- the YAML subset of the recipes --------------------------------------

_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")


def _scalar(s: str):
    """A plain or quoted scalar, resolved as YAML 1.1 (PyYAML's safe_load) does."""
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    low = s.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s) and s not in (".", "+.", "-."):
        return float(s.replace("_", ""))
    return s


def _flow(s: str, i: int = 0):
    """A flow collection or scalar starting at s[i] -> (value, next index)."""
    while s[i] == " ":
        i += 1
    if s[i] in "[{":
        close, items, i = "]" if s[i] == "[" else "}", [], i + 1
        while True:
            while s[i] in " ,":
                i += 1
            if s[i] == close:
                break
            if close == "}":
                j = s.index(":", i)
                key = _scalar(s[i:j].strip())
                val, i = _flow(s, j + 1)
                items.append((key, val))
            else:
                val, i = _flow(s, i)
                items.append(val)
        return (dict(items) if close == "}" else items), i + 1
    j = i
    while j < len(s) and s[j] not in ",]}":
        j += 1
    return _scalar(s[i:j].strip()), j


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _block_item(blocks: list, item: str, n: int) -> None:
    """Append `item` (a scalar or a flow collection) to the block sequence
    of the last key opened with nothing after it."""
    if not item or item.startswith("-") or (item[0] not in "[{'\"" and (
            ": " in item or item.endswith(":"))):
        raise ValueError(f"YAML line {n}: a block sequence of sequences or mappings is not "
                         f"read here; write it as a flow list")
    holder, key = blocks[-1]
    if holder[key] == {}:
        holder[key] = []
    if not isinstance(holder[key], list):
        raise ValueError(f"YAML line {n}: a sequence item under a mapping")
    holder[key].append(_flow(item)[0])


def parse_yaml(text: str) -> dict:
    """Block mappings nested by indentation whose values are scalars, flow
    lists / mappings, block sequences of those, or further block mappings
    (a key with nothing under it is null).  Any other YAML raises."""
    root: dict = {}
    stack = [(-1, root)]
    blocks = []
    for n, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        while stack[-1][0] >= indent:
            stack.pop()
        if line.strip() == "-" or line.strip().startswith("- "):
            _block_item(blocks, line.strip()[1:].strip(), n)
            continue
        key, _, rest = line.strip().partition(":")
        parent, rest = stack[-1][1], rest.strip()
        if rest:
            parent[_scalar(key)] = _flow(rest)[0]
        else:
            parent[_scalar(key)] = child = {}
            stack.append((indent, child))
            blocks.append((parent, _scalar(key)))
    for parent, key in reversed(blocks):
        if parent[key] == {}:
            parent[key] = None
    return root
