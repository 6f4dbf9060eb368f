"""Typed configs from the example recipes: YAML -> config dataclasses ->
the port's models.

Port of cosyvoice_tpu/config.py: the same 17 model kinds and the same map
of nested config fields, over the port's classes.  `build_model(kind,
overrides, device)` builds the config dataclass from a dict (an unknown key
raises KeyError; lists become tuples) and constructs the module, under
`device` when one is given (torch.device("meta") builds a full-width model
without memory).  The recipes' training-only keys (dropout rates, loss
settings) are fields of the port's configs that no inference code reads.

The recipes are read by a small YAML reader (block mappings by
indentation, flow lists and mappings, block sequences of those, plain,
quoted and !!-tagged scalars resolved by PyYAML's YAML 1.1 rules, literal
and folded block scalars, comments; anything else raises ValueError), so
the port needs no YAML package; tests/test_torch_config.py holds it equal
to yaml.safe_load on every recipe and on each scalar form.
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
# Plain scalars resolve by PyYAML's YAML 1.1 rules (its implicit resolvers
# and constructors), so safe_load and this reader agree on every form they
# both read; any other form raises ValueError.

_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
         "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
         "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?(0|[1-9][0-9_]*)$"
                  r"|[-+]?0x[0-9a-fA-F_]+$|[-+]?[1-9][0-9_]*(:[0-5]?[0-9])+$")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*([eE][-+][0-9]+)?$"
                    r"|[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+\.[0-9_]*$"
                    r"|[-+]?\.(inf|Inf|INF)$|\.(nan|NaN|NAN)$")
_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(digits: str, cast):
    value = 0
    for part in digits.split(":"):
        value = value * 60 + cast(part)
    return value


def _yaml_int(s: str) -> int:
    """PyYAML's construct_yaml_int: binary, octal (a leading 0), hex and
    base-60 forms, underscores dropped."""
    v = s.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    v = v[1:] if v[0] in "+-" else v
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    return sign * int(v)


def _yaml_float(s: str) -> float:
    """PyYAML's construct_yaml_float."""
    v = s.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    v = v[1:] if v[0] in "+-" else v
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def _plain(s: str):
    """A plain scalar resolved as PyYAML's safe_load resolves it."""
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return _yaml_int(s)
    if _FLOAT.match(s):
        return _yaml_float(s)
    if _TIMESTAMP.match(s):
        raise ValueError(f"YAML timestamp {s!r} is not read here; quote it")
    if s[:1] in "&*!|>%@`" or s.startswith(("<<", "? ")):
        raise ValueError(f"YAML form {s!r} is not read here")
    return s


def _double_quoted(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1] if i + 1 < len(body) else ""
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"YAML escape \\{e} is not read here")
    return "".join(out)


_TAGS = {"!!str": str, "!!int": _yaml_int, "!!float": _yaml_float,
         "!!bool": lambda s: _BOOL[s], "!!null": lambda s: None}


def _scalar(s: str):
    """A plain, quoted or !!-tagged scalar, resolved as YAML 1.1 (PyYAML's
    safe_load) does."""
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return _double_quoted(s[1:-1])
    if s.startswith("!!"):
        tag, _, value = s.partition(" ")
        if tag not in _TAGS:
            raise ValueError(f"YAML tag {tag} is not read here")
        value = value.strip()
        return _TAGS[tag](_scalar(value) if value[:1] in "'\"" else value)
    return _plain(s)


def _flow(s: str, i: int = 0):
    """A flow collection or scalar starting at s[i] -> (value, next index)."""
    while s[i] == " ":
        i += 1
    if s[i] in "[{":
        close, items, i = "]" if s[i] == "[" else "}", [], i + 1
        while True:
            while i < len(s) and s[i] in " ,":
                i += 1
            if i >= len(s):
                raise ValueError(f"YAML flow collection {s!r} does not close on its line")
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
    if s[i] in "'\"":
        j = i + 1
        while j < len(s) and (s[j] != s[i] or (s[i] == "'" and s[j + 1:j + 2] == "'")):
            j += 2 if s[i] == "'" and s[j:j + 2] == "''" else 1 + (s[j] == "\\")
        return _scalar(s[i:j + 1]), j + 1
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


_BLOCK_SCALAR = re.compile(r"([|>])([-+]?)$")


def _block_scalar(style: str, chomp: str, lines: list, n: int) -> str:
    """The text of a literal (|) or folded (>) block scalar from its raw
    lines (each indented past its key, or empty), with clip, strip (-) or
    keep (+) chomping; a folded scalar with more-indented lines raises."""
    body = list(lines)
    while body and not body[-1].strip():
        body.pop()
    trailing = len(lines) - len(body)
    if not body:
        return "\n" * trailing if chomp == "+" else ""
    depth = [len(ln) - len(ln.lstrip(" ")) for ln in body if ln.strip()]
    indent = depth[0]
    if min(depth) < indent:
        raise ValueError(f"YAML line {n}: a block scalar line indented less than its first")
    text = [ln[indent:] if ln.strip() else "" for ln in body]
    if style == "|":
        out = "\n".join(text)
    else:
        if any(t[:1] in (" ", "\t") for t in text):
            raise ValueError(f"YAML line {n}: more-indented lines of a folded scalar are not "
                             f"read here")
        out, blanks = text[0], 0
        for t in text[1:]:
            if not t:
                blanks += 1
                continue
            out += ("\n" * blanks if blanks else " ") + t
            blanks = 0
    if chomp == "-":
        return out
    return out + "\n" + ("\n" * trailing if chomp == "+" else "")


def parse_yaml(text: str) -> dict:
    """Block mappings nested by indentation whose values are scalars (plain,
    quoted, !!-tagged or | / > block scalars), flow lists / mappings, block
    sequences of those, or further block mappings (a key with nothing under
    it is null).  Any other YAML raises ValueError."""
    root: dict = {}
    stack = [(-1, root)]
    blocks = []
    raw_lines = text.splitlines()
    n = 0
    while n < len(raw_lines):
        raw = raw_lines[n]
        n += 1
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"YAML line {n}: tab indentation")
        indent = len(line) - len(line.lstrip(" "))
        while stack[-1][0] >= indent:
            stack.pop()
        if line.strip() == "-" or line.strip().startswith("- "):
            _block_item(blocks, line.strip()[1:].strip(), n)
            continue
        if line.strip() in ("---", "...") or line.startswith("%"):
            raise ValueError(f"YAML line {n}: documents and directives are not read here")
        stripped = line.strip()
        if stripped[:1] in "'\"":
            key_end = _flow(stripped)[1]
            key, rest = stripped[:key_end], stripped[key_end:]
            if not rest.startswith(":"):
                raise ValueError(f"YAML line {n}: a quoted key without ':'")
            rest = rest[1:]
        else:
            key, colon, rest = stripped.partition(": ")
            if not colon:
                if not stripped.endswith(":"):
                    raise ValueError(f"YAML line {n}: {stripped!r} is neither a key nor a "
                                     f"sequence item (multi-line plain scalars are not read "
                                     f"here)")
                key, rest = stripped[:-1], ""
        key, parent, rest = _scalar(key.strip()), stack[-1][1], rest.strip()
        m = _BLOCK_SCALAR.match(rest)
        if m:
            lines = []
            while n < len(raw_lines) and (not raw_lines[n].strip() or (
                    len(raw_lines[n]) - len(raw_lines[n].lstrip(" ")) > indent)):
                lines.append(raw_lines[n].rstrip())
                n += 1
            parent[key] = _block_scalar(m.group(1), m.group(2), lines, n)
        elif rest:
            value, end = _flow(rest)
            if rest[end:].strip():
                raise ValueError(f"YAML line {n}: {rest!r} is not one value")
            parent[key] = value
        else:
            parent[key] = child = {}
            stack.append((indent, child))
            blocks.append((parent, key))
    for parent, key in reversed(blocks):
        if parent[key] == {}:
            parent[key] = None
    return root
