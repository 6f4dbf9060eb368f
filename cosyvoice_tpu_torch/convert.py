"""JAX parameter trees -> the port's state_dicts (CosyVoice2's modules,
CosyVoice v1's TransformerLM and MaskedDiffWithXvec, and the phoneme LMs).

Each function takes a flax param tree (nested dicts of numpy or JAX arrays,
with or without the top-level "params" key) and returns a state_dict that the
port's module loads with `load_state_dict(strict=True)`.  Dense kernels
[in, out] become weights [out, in]; int8 QDense leaves keep their int8
kernel (transposed) and fp32 scale [out]; packed-int4 QDense leaves (kernel
[in/2, out], scale [in/g, out]) keep the JAX layout unchanged; conv kernels
[K, Cin, Cout] become [Cout, Cin, K]; weight-norm (g, v) pairs become
weight_g / weight_v, and a weight-normed transposed conv (stored k-flipped,
in forward-correlation form) becomes torch's [Cin, Cout, K], as does a
plain transposed conv's kernel.
"""
from __future__ import annotations

import re

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _root(params: dict) -> dict:
    return params["params"] if "params" in params else params


def _indices(tree: dict, prefix: str) -> list[int]:
    pat = re.compile(re.escape(prefix) + r"(\d+)$")
    return sorted(int(m.group(1)) for k in tree if (m := pat.match(k)))


def _dense(sd, name, p):
    packed_int4 = "scale" in p and np.ndim(p["scale"]) == 2
    kernel = np.asarray(p["kernel"])
    sd[f"{name}.weight"] = _t(kernel if packed_int4 else kernel.T)
    if "scale" in p:
        sd[f"{name}.scale"] = _t(p["scale"])
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _ln(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _conv(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _wn_conv(sd, name, p):
    g = np.asarray(p["g"])
    sd[f"{name}.weight_g"] = _t(g.reshape(-1, 1, 1))
    sd[f"{name}.weight_v"] = _t(np.asarray(p["v"]).transpose(2, 1, 0))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _convT(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"])[::-1].transpose(1, 2, 0))
    sd[f"{name}.bias"] = _t(p["bias"])


def _wn_convT(sd, name, p):
    sd[f"{name}.weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1))
    sd[f"{name}.weight_v"] = _t(np.asarray(p["v"])[::-1].transpose(1, 2, 0))
    sd[f"{name}.bias"] = _t(p["bias"])


def lm_state_from_jax(params: dict) -> dict:
    """models/llm.py Qwen2LM params -> port Qwen2LM state_dict."""
    p = _root(params)
    body, pre = p["llm"], "llm.model.model."
    sd = {pre + "embed_tokens.weight": _t(body["embed_tokens"]["embedding"]),
          pre + "norm.weight": _t(body["norm"])}
    for i in _indices(body, "layers_"):
        lp, d = body[f"layers_{i}"], f"{pre}layers.{i}."
        sd[d + "input_layernorm.weight"] = _t(lp["input_layernorm"])
        sd[d + "post_attention_layernorm.weight"] = _t(lp["post_attention_layernorm"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _dense(sd, d + "self_attn." + name, lp[name])
        for name in ("gate_proj", "up_proj", "down_proj"):
            _dense(sd, d + "mlp." + name, lp[name])
    sd["llm_embedding.weight"] = _t(p["llm_embedding"]["embedding"])
    sd["speech_embedding.weight"] = _t(p["speech_embedding"]["embedding"])
    _dense(sd, "llm_decoder", p["llm_decoder"])
    return sd


def _conformer_layer(sd, name, p, norms=("norm_mha", "norm_ff")):
    _ln(sd, f"{name}.{norms[0]}", p["norm_mha"])
    _ln(sd, f"{name}.{norms[1]}", p["norm_ff"])
    att = p["self_attn"]
    for lin in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
        _dense(sd, f"{name}.self_attn.{lin}", att[lin])
    sd[f"{name}.self_attn.pos_bias_u"] = _t(att["pos_bias_u"])
    sd[f"{name}.self_attn.pos_bias_v"] = _t(att["pos_bias_v"])
    _dense(sd, f"{name}.feed_forward.w_1", p["ff"]["w_1"])
    _dense(sd, f"{name}.feed_forward.w_2", p["ff"]["w_2"])
    if "spk_linear" in p:       # a speaker-adaptive layer (ConformerConfig.spk_adapt)
        _dense(sd, f"{name}.spk_linear", p["spk_linear"])


def _encoder(sd, pre, p):
    for emb in ("embed", "up_embed"):
        _dense(sd, f"{pre}{emb}.out.0", p[emb]["linear"])
        _ln(sd, f"{pre}{emb}.out.1", p[emb]["norm"])
    _conv(sd, f"{pre}pre_lookahead_layer.conv1", p["pre_lookahead_layer"]["conv1"])
    _conv(sd, f"{pre}pre_lookahead_layer.conv2", p["pre_lookahead_layer"]["conv2"])
    _conv(sd, f"{pre}up_layer.conv", p["up_layer"]["conv"])
    _ln(sd, f"{pre}after_norm", p["after_norm"])
    for group in ("encoders", "up_encoders"):
        for i in _indices(p, f"{group}_"):
            _conformer_layer(sd, f"{pre}{group}.{i}", p[f"{group}_{i}"])


def _conformer_encoder(sd, pre, p, transformer_layer: bool = False):
    """models/conformer.py ConformerEncoder (JAX `layers_{i}`) -> the
    reference's `encoders.{i}` (a TransformerEncoder's norms are norm1/norm2)."""
    _dense(sd, f"{pre}embed.out.0", p["embed"]["linear"])
    _ln(sd, f"{pre}embed.out.1", p["embed"]["norm"])
    _ln(sd, f"{pre}after_norm", p["after_norm"])
    norms = ("norm1", "norm2") if transformer_layer else ("norm_mha", "norm_ff")
    for i in _indices(p, "layers_"):
        _conformer_layer(sd, f"{pre}encoders.{i}", p[f"layers_{i}"], norms)


def _estimator(sd, pre, p, causal: bool = True):
    def block1d(name, q):   # CausalBlock1D: LayerNorm at block.2; Block1D: GroupNorm at block.1
        _conv(sd, f"{name}.block.0", q["conv"])
        _ln(sd, f"{name}.block.{2 if causal else 1}", q["norm"])

    def resnet(name, q):
        block1d(f"{name}.block1", q["block1"])
        block1d(f"{name}.block2", q["block2"])
        _dense(sd, f"{name}.mlp.1", q["mlp"])
        _conv(sd, f"{name}.res_conv", q["res_conv"])

    def tb(name, q):
        _ln(sd, f"{name}.norm1", q["norm1"])
        _ln(sd, f"{name}.norm3", q["norm3"])
        for w in ("to_q", "to_k", "to_v"):
            sd[f"{name}.attn1.{w}.weight"] = _t(np.asarray(q[w]).T)
        _dense(sd, f"{name}.attn1.to_out.0", q["to_out"])
        _dense(sd, f"{name}.ff.net.0.proj", q["ff_in"])
        _dense(sd, f"{name}.ff.net.2", q["ff_out"])

    _dense(sd, pre + "time_mlp.linear_1", p["time_mlp"]["linear_1"])
    _dense(sd, pre + "time_mlp.linear_2", p["time_mlp"]["linear_2"])
    levels = {k[:-len("_resnet")] for k in p if k.endswith("_resnet")}
    for kind in ("down", "mid", "up"):
        for i in _indices(levels, f"{kind}_"):
            name = f"{pre}{kind}_blocks.{i}"
            resnet(f"{name}.0", p[f"{kind}_{i}_resnet"])
            for j in _indices(p, f"{kind}_{i}_tb_"):
                tb(f"{name}.1.{j}", p[f"{kind}_{i}_tb_{j}"])
            if kind != "mid":   # a Downsample1D / Upsample1DT, or the closing conv
                q = p[f"{kind}_{i}_{'downsample' if kind == 'down' else 'upsample'}"]
                if "conv" not in q:
                    _conv(sd, f"{name}.2", q)
                elif kind == "down":
                    _conv(sd, f"{name}.2.conv", q["conv"])
                else:
                    _convT(sd, f"{name}.2.conv", q["conv"])
    block1d(pre + "final_block", p["final_block"])
    _conv(sd, pre + "final_proj", p["final_proj"])


def flow_state_from_jax(params: dict) -> dict:
    """models/flow.py CausalMaskedDiffWithXvec params -> port state_dict."""
    p = _root(params)
    sd = {"input_embedding.weight": _t(p["input_embedding"]["embedding"])}
    _dense(sd, "spk_embed_affine_layer", p["spk_embed_affine_layer"])
    _dense(sd, "encoder_proj", p["encoder_proj"])
    _encoder(sd, "encoder.", p["encoder"])
    _estimator(sd, "decoder.estimator.", p["decoder"]["estimator"])
    return sd


def estimator_state_from_jax(params: dict, causal: bool = True) -> dict:
    """models/flow.py ConditionalDecoder params -> port state_dict (`causal`
    as the estimator's config has it: it places Block1D's norm)."""
    sd: dict = {}
    _estimator(sd, "", _root(params), causal)
    return sd


def conformer_encoder_state_from_jax(params: dict, transformer_layer: bool = False) -> dict:
    """models/conformer.py ConformerEncoder params -> port state_dict."""
    sd: dict = {}
    _conformer_encoder(sd, "", _root(params), transformer_layer)
    return sd


def _v1_lm(sd, p):
    """The v1 LM's tree but its text embedding."""
    for emb in ("llm_embedding", "speech_embedding"):
        sd[f"{emb}.weight"] = _t(p[emb]["embedding"])
    for lin in ("text_encoder_affine_layer", "llm_decoder", "spk_embed_affine_layer"):
        _dense(sd, lin, p[lin])
    _conformer_encoder(sd, "text_encoder.", p["text_encoder"])
    _conformer_encoder(sd, "llm.", p["llm"], transformer_layer=True)
    return sd


def _phoneme_embedding(sd, p):
    """PhonemeEmbedding's four tables (JAX `embed_{i}`) -> `text_embedding.{i}`."""
    for i in _indices(p["text_embedding"], "embed_"):
        sd[f"text_embedding.{i}.weight"] = _t(p["text_embedding"][f"embed_{i}"]["embedding"])


def transformer_lm_state_from_jax(params: dict) -> dict:
    """models/llm.py TransformerLM (CosyVoice v1) params -> port state_dict."""
    p = _root(params)
    return _v1_lm({"text_embedding.weight": _t(p["text_embedding"]["embedding"])}, p)


def v1_phoneme_lm_state_from_jax(params: dict) -> dict:
    """models/llm_v1_phoneme.py TransformerLMPhoneme params -> port
    state_dict (a spk_adapt text encoder's `spk_linear`s come with their
    layers)."""
    p = _root(params)
    sd: dict = {}
    _phoneme_embedding(sd, p)
    return _v1_lm(sd, p)


def phoneme_lm_state_from_jax(params: dict) -> dict:
    """models/llm_phoneme.py Qwen2LMPhoneme / Qwen2LMPhonemeSrc /
    Qwen2LMPhonemeSrc2 params -> port state_dict; the fusion layer (the
    Src variants' `src_attention`) comes when the tree has one."""
    p = _root(params)
    sd = lm_state_from_jax(p)       # the Qwen2 body, llm/speech embeddings, head
    _phoneme_embedding(sd, p)
    _conformer_encoder(sd, "text_encoder.", p["text_encoder"])
    for lin in ("text_encoder_affine_layer", "spk_embed_affine_layer"):
        _dense(sd, lin, p[lin])
    if "src_attention" in p:
        f, pre = p["src_attention"], "src_attention.0."
        for norm in ("norm1", "norm2", "norm3"):
            _ln(sd, pre + norm, f[norm])
        for att in ("self_attn", "src_attn"):
            for lin in ("linear_q", "linear_k", "linear_v", "linear_out"):
                _dense(sd, f"{pre}{att}.{lin}", f[att][lin])
        _dense(sd, pre + "feed_forward.w_1", f["ff_w1"])
        _dense(sd, pre + "feed_forward.w_2", f["ff_w2"])
    return sd


def flow_v1_state_from_jax(params: dict) -> dict:
    """models/flow.py MaskedDiffWithXvec (CosyVoice v1) params -> port
    state_dict: the non-causal estimator (GroupNorm Block1D, Downsample1D /
    Upsample1DT between levels) and the length regulator's `model.{k}`."""
    p = _root(params)
    sd = {"input_embedding.weight": _t(p["input_embedding"]["embedding"])}
    _dense(sd, "spk_embed_affine_layer", p["spk_embed_affine_layer"])
    _dense(sd, "encoder_proj", p["encoder_proj"])
    _conformer_encoder(sd, "encoder.", p["encoder"])
    reg = p["length_regulator"]
    n = len(_indices(reg, "conv_"))
    for i in range(n):
        _conv(sd, f"length_regulator.model.{3 * i}", reg[f"conv_{i}"])
        _ln(sd, f"length_regulator.model.{3 * i + 1}", reg[f"norm_{i}"])
    _conv(sd, f"length_regulator.model.{3 * n}", reg["out_conv"])
    _estimator(sd, "decoder.estimator.", p["decoder"]["estimator"], causal=False)
    return sd


def encoder_state_from_jax(params: dict) -> dict:
    """models/conformer.py UpsampleConformerEncoder params -> port state_dict."""
    sd: dict = {}
    _encoder(sd, "", _root(params))
    return sd


def hift_state_from_jax(params: dict) -> dict:
    """models/hift.py HiFTGenerator params -> port state_dict."""
    p = _root(params)
    sd: dict = {}
    _wn_conv(sd, "conv_pre", p["conv_pre"])
    _wn_conv(sd, "conv_post", p["conv_post"])
    _dense(sd, "m_source.l_linear", p["m_source"]["l_linear"])
    f0 = p["f0_predictor"]
    for i in _indices(f0, "conv_"):
        _wn_conv(sd, f"f0_predictor.condnet.{2 * i}", f0[f"conv_{i}"])
    _dense(sd, "f0_predictor.classifier", f0["classifier"])

    def resblock(name, q):
        for j in _indices(q, "convs1_"):
            _wn_conv(sd, f"{name}.convs1.{j}", q[f"convs1_{j}"])
            _wn_conv(sd, f"{name}.convs2.{j}", q[f"convs2_{j}"])
            sd[f"{name}.activations1.{j}.alpha"] = _t(q[f"act1_{j}"]["alpha"])
            sd[f"{name}.activations2.{j}.alpha"] = _t(q[f"act2_{j}"]["alpha"])

    ups = _indices(p, "ups_")
    nk = len([k for k in p if k.startswith("resblocks_0_")])
    for i in ups:
        _wn_convT(sd, f"ups.{i}", p[f"ups_{i}"])
        _conv(sd, f"source_downs.{i}", p[f"source_downs_{i}"])
        resblock(f"source_resblocks.{i}", p[f"source_resblocks_{i}"])
        for j in range(nk):
            resblock(f"resblocks.{i * nk + j}", p[f"resblocks_{i}_{j}"])
    return sd


def bigvgan_state_from_jax(params: dict, cfg) -> dict:
    """models/bigvgan.py BigVGAN params -> port (and reference checkpoint)
    state_dict; the inverse of the JAX package's import_bigvgan_torch."""
    p = _root(params)
    sd = {"input_embedding.weight": _t(p["input_embedding"]["embedding"])}
    _dense(sd, "encoder_proj", p["encoder_proj"])
    _dense(sd, "mel_proj", p["mel_proj"])
    _wn_conv(sd, "conv_pre", p["conv_pre"])
    _wn_conv(sd, "conv_post", p["conv_post"])
    _conv(sd, "cond_layer", p["cond_layer"])

    def aa_act(name, q):
        sd[f"{name}.act.alpha"] = _t(q["alpha"])
        if "beta" in q:
            sd[f"{name}.act.beta"] = _t(q["beta"])

    aa_act("activation_post", p["activation_post"])
    for enc in ("encoder1", "encoder2"):
        if getattr(cfg, enc) is not None:
            _encoder(sd, f"{enc}.", p[enc])
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        _wn_convT(sd, f"ups.{i}.0", p[f"ups_{i}"])
        if cfg.cond_in_each_up_layer:
            _conv(sd, f"conds.{i}", p[f"conds_{i}"])
        for j in range(nk):
            q, name = p[f"resblocks_{i}_{j}"], f"resblocks.{i * nk + j}"
            for conv in ("convs1", "convs2"):       # convs2 only in AMPBlock1
                for d in _indices(q, f"{conv}_"):
                    _wn_conv(sd, f"{name}.{conv}.{d}", q[f"{conv}_{d}"])
            for a in _indices(q, "act_"):
                aa_act(f"{name}.activations.{a}", q[f"act_{a}"])
    return sd
