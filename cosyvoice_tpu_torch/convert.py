"""JAX parameter trees -> the port's state_dicts (CosyVoice2's modules,
CosyVoice v1's TransformerLM and MaskedDiffWithXvec, the phoneme LMs and the
multi-code LM, the conformer's options and front ends, the wenet decoders,
VITS, CAMPPlus, the LAM speaker embedding and the GAN discriminators).

Each function takes a flax param tree (nested dicts of numpy or JAX arrays,
with or without the top-level "params" key) and returns a state_dict that the
port's module loads with `load_state_dict(strict=True)`.  Dense kernels
[in, out] become weights [out, in]; int8 QDense leaves keep their int8
kernel (transposed) and fp32 scale [out]; packed-int4 QDense leaves (kernel
[in/2, out], scale [in/g, out]) and int4xla ones (int8 nibble values
[in, out], the same scales) keep the JAX layout unchanged; conv kernels
[K, Cin, Cout] become [Cout, Cin, K]; weight-norm (g, v) pairs become
weight_g / weight_v, and a weight-normed transposed conv (stored k-flipped,
in forward-correlation form) becomes torch's [Cin, Cout, K], as does a
plain transposed conv's kernel.  `train_state_from_jax` carries a
training run's trees (params, gradients) by registry kind, a LoRA train
state's too; `lora_overlay_from_jax` maps a JAX LoRA overlay (or its
lora.npz) to the port's parameter names.  `lm_state_to_jax`,
`flow_state_to_jax` and `hift_state_to_jax` go the other way (the JAX
trees that bin/ckpt_resave.py --out_prefix writes).
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
    if "llm_decoder" in p:      # the multi-code LM's tree has none
        _dense(sd, "llm_decoder", p["llm_decoder"])
    return sd


def _moe(sd, name, p):
    """MoEFFNLayer's stacked experts (w1 [E, D, H], b1, w2 [E, H, D], b2) ->
    the reference's `experts.{e}.w_1` / `w_2` and the router `gate`."""
    _dense(sd, f"{name}.gate", p["gate"])
    for e in range(np.shape(p["w1"])[0]):
        for w, b, lin in (("w1", "b1", "w_1"), ("w2", "b2", "w_2")):
            sd[f"{name}.experts.{e}.{lin}.weight"] = _t(np.asarray(p[w])[e].T)
            sd[f"{name}.experts.{e}.{lin}.bias"] = _t(np.asarray(p[b])[e])


def _conv_module(sd, name, p, stats, batch_norm: bool):
    """ConvolutionModule; with `batch_norm`, its norm's running statistics
    from the `batch_stats` subtree `stats` (flax's initial 0 / 1 where it
    has none)."""
    for conv in ("pointwise_conv1", "depthwise_conv", "pointwise_conv2"):
        _conv(sd, f"{name}.{conv}", p[conv])
    _ln(sd, f"{name}.norm", p["norm"])
    if batch_norm:
        st = (stats or {}).get("norm", {})
        c = np.shape(p["norm"]["scale"])[0]
        sd[f"{name}.norm.running_mean"] = _t(st.get("mean", np.zeros(c, np.float32)))
        sd[f"{name}.norm.running_var"] = _t(st.get("var", np.ones(c, np.float32)))
        sd[f"{name}.norm.num_batches_tracked"] = torch.tensor(0)


def _conformer_layer(sd, name, p, norms=("norm_mha", "norm_ff"), stats=None,
                     batch_norm: bool = False):
    """One encoder layer; `stats` its `batch_stats` subtree, `batch_norm`
    whether its conv module's norm is a BatchNorm."""
    _ln(sd, f"{name}.{norms[0]}", p["norm_mha"])
    _ln(sd, f"{name}.{norms[1]}", p["norm_ff"])
    att = p["self_attn"]
    for lin in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
        _dense(sd, f"{name}.self_attn.{lin}", att[lin])
    sd[f"{name}.self_attn.pos_bias_u"] = _t(att["pos_bias_u"])
    sd[f"{name}.self_attn.pos_bias_v"] = _t(att["pos_bias_v"])
    if "gate" in p["ff"]:       # ffn_type="moe"
        _moe(sd, f"{name}.feed_forward", p["ff"])
    else:
        _dense(sd, f"{name}.feed_forward.w_1", p["ff"]["w_1"])
        _dense(sd, f"{name}.feed_forward.w_2", p["ff"]["w_2"])
    if "spk_linear" in p:       # a speaker-adaptive layer (ConformerConfig.spk_adapt)
        _dense(sd, f"{name}.spk_linear", p["spk_linear"])
    if "ff_macaron" in p:       # macaron_style
        _ln(sd, f"{name}.norm_ff_macaron", p["norm_ff_macaron"])
        _dense(sd, f"{name}.feed_forward_macaron.w_1", p["ff_macaron"]["w_1"])
        _dense(sd, f"{name}.feed_forward_macaron.w_2", p["ff_macaron"]["w_2"])
    if "conv_module" in p:      # use_cnn_module
        _ln(sd, f"{name}.norm_conv", p["norm_conv"])
        _ln(sd, f"{name}.norm_final", p["norm_final"])
        _conv_module(sd, f"{name}.conv_module", p["conv_module"],
                     (stats or {}).get("conv_module"), batch_norm)


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


def _conformer_encoder(sd, pre, p, transformer_layer: bool = False, stats=None,
                       batch_norm: bool = False):
    """models/conformer.py ConformerEncoder (JAX `layers_{i}`) -> the
    reference's `encoders.{i}` (a TransformerEncoder's norms are norm1/norm2)."""
    _dense(sd, f"{pre}embed.out.0", p["embed"]["linear"])
    _ln(sd, f"{pre}embed.out.1", p["embed"]["norm"])
    _ln(sd, f"{pre}after_norm", p["after_norm"])
    norms = ("norm1", "norm2") if transformer_layer else ("norm_mha", "norm_ff")
    for i in _indices(p, "layers_"):
        _conformer_layer(sd, f"{pre}encoders.{i}", p[f"layers_{i}"], norms,
                         (stats or {}).get(f"layers_{i}"), batch_norm)


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


def conformer_encoder_state_from_jax(params: dict, transformer_layer: bool = False,
                                     batch_norm: bool = False) -> dict:
    """models/conformer.py ConformerEncoder variables -> port state_dict;
    with `batch_norm` (cnn_norm="batch_norm") the conv modules' running
    statistics come from the variables' `batch_stats`."""
    sd: dict = {}
    _conformer_encoder(sd, "", _root(params), transformer_layer, params.get("batch_stats"),
                       batch_norm)
    return sd


def moe_state_from_jax(params: dict) -> dict:
    """models/conformer.py MoEFFNLayer params -> port state_dict."""
    sd: dict = {}
    _moe(sd, "", _root(params))
    return {k[1:]: v for k, v in sd.items()}


def conv_module_state_from_jax(params: dict, batch_norm: bool = False) -> dict:
    """models/conformer.py ConvolutionModule variables -> port state_dict."""
    sd: dict = {}
    _conv_module(sd, "", _root(params), params.get("batch_stats"), batch_norm)
    return {k[1:]: v for k, v in sd.items()}


def subsampling_state_from_jax(params: dict, rate: int) -> dict:
    """models/conformer.py Conv1dSubsampling2 (rate 2) / Conv2dSubsampling4,
    6, 8 params -> port state_dict: conv{i} -> conv.{2i}, out -> out.0
    (rate 4) or linear (rates 6, 8)."""
    p, sd = _root(params), {}
    for i in _indices(p, "conv"):
        k = np.asarray(p[f"conv{i}"]["kernel"])       # [k, Cin, Cout] / [kh, kw, Cin, Cout]
        sd[f"conv.{2 * i}.weight"] = _t(k.transpose(2, 1, 0) if k.ndim == 3
                                        else k.transpose(3, 2, 0, 1))
        sd[f"conv.{2 * i}.bias"] = _t(p[f"conv{i}"]["bias"])
    if "out" in p:
        _dense(sd, "out.0" if rate == 4 else "linear", p["out"])
    return sd


def transformer_decoder_state_from_jax(params: dict, prefix: str = "") -> dict:
    """models/decoder.py TransformerDecoder params -> port state_dict (the
    reference's names) under `prefix`."""
    p = _root(params)
    sd = {f"{prefix}embed.0.weight": _t(p["embed"]["embedding"])}
    _ln(sd, f"{prefix}after_norm", p["after_norm"])
    if "output_layer" in p:
        _dense(sd, f"{prefix}output_layer", p["output_layer"])
    for i in _indices(p, "decoders_"):
        _fusion_layer(sd, f"{prefix}decoders.{i}.", p[f"decoders_{i}"])
    return sd


def bi_transformer_decoder_state_from_jax(params: dict) -> dict:
    """models/decoder.py BiTransformerDecoder params -> port state_dict."""
    p = _root(params)
    sd = transformer_decoder_state_from_jax(p["left_decoder"], "left_decoder.")
    if "right_decoder" in p:
        sd.update(transformer_decoder_state_from_jax(p["right_decoder"], "right_decoder."))
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
        _fusion_layer(sd, "src_attention.0.", p["src_attention"])
    return sd


def _fusion_layer(sd, pre, f):
    """A fusion DecoderLayer (models/llm_phoneme.py): its norms, two
    attentions and ReLU FFN (JAX ff_w1 / ff_w2 -> feed_forward.w_1 / w_2)."""
    for norm in ("norm1", "norm2", "norm3"):
        if norm in f:
            _ln(sd, pre + norm, f[norm])
    for att in ("self_attn", "src_attn"):
        if att in f:            # a decoder layer without src_attention has none
            for lin in ("linear_q", "linear_k", "linear_v", "linear_out"):
                _dense(sd, f"{pre}{att}.{lin}", f[att][lin])
    _dense(sd, pre + "feed_forward.w_1", f["ff_w1"])
    _dense(sd, pre + "feed_forward.w_2", f["ff_w2"])


def multicode_lm_state_from_jax(params: dict) -> dict:
    """models/llm_multicode.py Qwen2LMPhonemeMultiCode params -> port
    state_dict: the phoneme LM's pieces, the fusion layers
    (`src_attention_{i}`), the code tables (`code_embed_{i}`) and the
    ARDecoder head."""
    p = _root(params)
    sd = phoneme_lm_state_from_jax(p)
    for i in _indices(p, "src_attention_"):
        _fusion_layer(sd, f"src_attention.{i}.", p[f"src_attention_{i}"])
    for i in _indices(p, "code_embed_"):
        sd[f"code_embeddings.{i}.weight"] = _t(p[f"code_embed_{i}"]["embedding"])
    _dense(sd, "ar_decoder.model", p["ar_decoder"]["model"])
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


# ---- VITS, the LAM speaker embedding, the speaker-co-trained v1 LM ----------

def _gamma_beta(sd, name, p):
    """A flax LayerNorm -> the reference's `gamma` / `beta` LayerNorm."""
    sd[f"{name}.gamma"] = _t(p["scale"])
    sd[f"{name}.beta"] = _t(p["bias"])


def _wn(sd, name, p):
    """models/vits.py WN (JAX `in_{i}`, `res_skip_{i}`, `cond_layer`) ->
    `in_layers.{i}`, `res_skip_layers.{i}`, `cond_layer`."""
    if "cond_layer" in p:
        _wn_conv(sd, f"{name}.cond_layer", p["cond_layer"])
    for i in _indices(p, "in_"):
        _wn_conv(sd, f"{name}.in_layers.{i}", p[f"in_{i}"])
        _wn_conv(sd, f"{name}.res_skip_layers.{i}", p[f"res_skip_{i}"])


def _posterior(sd, name, p):
    """The JAX `enc_q_pre`, `enc_q_wn`, `enc_q_proj` -> `enc_q.{pre,enc,proj}`."""
    _conv(sd, f"{name}.pre", p["enc_q_pre"])
    _wn(sd, f"{name}.enc", p["enc_q_wn"])
    _conv(sd, f"{name}.proj", p["enc_q_proj"])


def vits_state_from_jax(params: dict) -> dict:
    """models/vits.py VitsDecoder params -> port (and reference checkpoint)
    state_dict; the inverse of the JAX package's import_vits_torch."""
    p = _root(params)
    sd = {"enc_p.emb.weight": _t(p["emb"]["embedding"])}
    enc, pre = p["encoder"], "enc_p.encoder."
    for i in _indices(enc, "attn_"):
        att = enc[f"attn_{i}"]
        for conv in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _conv(sd, f"{pre}attn_layers.{i}.{conv}", att[conv])
        for rel in ("emb_rel_k", "emb_rel_v"):
            sd[f"{pre}attn_layers.{i}.{rel}"] = _t(att[rel])
        _gamma_beta(sd, f"{pre}norm_layers_1.{i}", enc[f"norm1_{i}"]["ln"])
        _gamma_beta(sd, f"{pre}norm_layers_2.{i}", enc[f"norm2_{i}"]["ln"])
        for conv in ("conv_1", "conv_2"):
            _conv(sd, f"{pre}ffn_layers.{i}.{conv}", enc[f"ffn_{i}"][conv])
    _conv(sd, "enc_p.proj", p["enc_proj"])
    for name in ("up_enc1", "up_enc2"):
        if name in p:
            _encoder(sd, f"enc_p.{name}.", p[name])
    _posterior(sd, "enc_q", p)
    for i in _indices(p["flow"], "flow_"):
        f = p["flow"][f"flow_{i}"]
        _conv(sd, f"flow.flows.{2 * i}.pre", f["pre"])
        _wn(sd, f"flow.flows.{2 * i}.enc", f["enc"])
        _conv(sd, f"flow.flows.{2 * i}.post", f["post"])
    dec = p["dec"]
    for conv in ("conv_pre", "cond", "conv_post"):
        _conv(sd, f"dec.{conv}", dec[conv])
    nk = len([k for k in dec if k.startswith("resblocks_0_")])
    for i in _indices(dec, "ups_"):
        _wn_convT(sd, f"dec.ups.{i}", dec[f"ups_{i}"])
        for j in range(nk):
            q = dec[f"resblocks_{i}_{j}"]
            for d in _indices(q, "convs1_"):
                for conv in ("convs1", "convs2"):
                    _wn_conv(sd, f"dec.resblocks.{i * nk + j}.{conv}.{d}", q[f"{conv}_{d}"])
    return sd


def conv_flow_state_from_jax(params: dict) -> dict:
    """models/vits.py ConvFlow params -> port (and reference) state_dict; the
    inverse of the JAX package's import_conv_flow_torch."""
    p = _root(params)
    sd: dict = {}
    _conv(sd, "pre", p["pre"])
    _conv(sd, "proj", p["proj"])
    c = p["convs"]
    for i in _indices(c, "convs_sep_"):
        _conv(sd, f"convs.convs_sep.{i}", c[f"convs_sep_{i}"])
        _conv(sd, f"convs.convs_1x1.{i}", c[f"convs_1x1_{i}"])
        _gamma_beta(sd, f"convs.norms_1.{i}", c[f"norms_1_{i}"])
        _gamma_beta(sd, f"convs.norms_2.{i}", c[f"norms_2_{i}"])
    return sd


def campplus_state_from_jax(variables: dict) -> dict:
    """models/campplus.py CAMPPlus {'params', 'batch_stats'} -> port (and
    reference) state_dict, BatchNorm counters 0; the inverse of the JAX
    package's import_campplus_torch."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}

    def conv2d(name, q):
        sd[f"{name}.weight"] = _t(np.asarray(q["kernel"]).transpose(3, 2, 0, 1))

    def bn(name, path):
        q, st = p, s
        for k in path + ("bn",):     # an init tree has no entry for an affine-free BN
            q, st = q.get(k, {}), st[k]
        if "scale" in q:
            sd[f"{name}.weight"] = _t(q["scale"])
            sd[f"{name}.bias"] = _t(q["bias"])
        sd[f"{name}.running_mean"] = _t(st["mean"])
        sd[f"{name}.running_var"] = _t(st["var"])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    head = p["head"]
    for i in (1, 2):
        conv2d(f"head.conv{i}", head[f"conv{i}"])
        bn(f"head.bn{i}", ("head", f"bn{i}"))
    for key in sorted(k for k in head if k.startswith("layer")):
        li, bi = key[len("layer"):].split("_")
        name = f"head.layer{li}.{bi}"
        for i in (1, 2):
            conv2d(f"{name}.conv{i}", head[key][f"conv{i}"])
            bn(f"{name}.bn{i}", ("head", key, f"bn{i}"))
        if "shortcut_conv" in head[key]:
            conv2d(f"{name}.shortcut.0", head[key]["shortcut_conv"])
            bn(f"{name}.shortcut.1", ("head", key, "shortcut_bn"))
    _conv(sd, "xvector.tdnn.linear", p["tdnn_conv"])
    bn("xvector.tdnn.nonlinear.batchnorm", ("tdnn_nl", "batchnorm"))
    for key in (k for k in p if re.fullmatch(r"block\d+_tdnnd\d+", k)):
        b, layer = key[len("block"):].split("_tdnnd")
        name = f"xvector.block{b}.tdnnd{layer}"
        bn(f"{name}.nonlinear1.batchnorm", (key, "nonlinear1", "batchnorm"))
        _conv(sd, f"{name}.linear1", p[key]["linear1"])
        bn(f"{name}.nonlinear2.batchnorm", (key, "nonlinear2", "batchnorm"))
        for conv in ("linear_local", "linear1", "linear2"):
            _conv(sd, f"{name}.cam_layer.{conv}", p[key]["cam_layer"][conv])
    for i in sorted(int(m.group(1)) for k in p if (m := re.fullmatch(r"transit(\d+)_conv", k))):
        bn(f"xvector.transit{i}.nonlinear.batchnorm", (f"transit{i}_nl", "batchnorm"))
        _conv(sd, f"xvector.transit{i}.linear", p[f"transit{i}_conv"])
    bn("xvector.out_nonlinear.batchnorm", ("out_nonlinear", "batchnorm"))
    sd["xvector.dense.linear.weight"] = _t(np.asarray(p["dense_linear"]["kernel"]).T[:, :, None])
    bn("xvector.dense.nonlinear.batchnorm", ("dense_nl", "batchnorm"))
    return sd


def speaker_embedding_state_from_jax(variables: dict) -> dict:
    """models/speaker.py SpeakerEmbedding (or SpeakerEmbeddingWoPostEnc)
    {'params', 'batch_stats'} -> port (and reference checkpoint) state_dict;
    the inverse of the JAX package's import_speaker_embedding_torch."""
    p = variables["params"]
    camp = campplus_state_from_jax({"params": p["speaker_encoder"],
                                    "batch_stats": variables["batch_stats"]["speaker_encoder"]})
    sd = {f"speaker_encoder.{k}": v for k, v in camp.items()}
    if "enc_q_pre" in p:
        _posterior(sd, "enc_q", p)
    st, pre = p["style_encoder"], "style_encoder."
    _dense(sd, pre + "in_fc.fc", st["in_fc"])
    _dense(sd, pre + "fc.fc", st["fc"])
    for i in _indices(st, "attn_"):
        _dense(sd, f"{pre}spectral_layers.{i}.0.fc", st[f"spectral_{i}_0"])
        _dense(sd, f"{pre}spectral_layers.{i}.3.fc", st[f"spectral_{i}_1"])
        for g in (0, 1):
            _conv(sd, f"{pre}temporal_layers.{i}.{g}.conv1.conv", st[f"glu_{i}_{g}"]["conv1"])
        for lin in ("w_qs", "w_ks", "w_vs", "fc"):
            _dense(sd, f"{pre}attn_layers.{i}.{lin}", st[f"attn_{i}"][lin])
    gst = p["gst"]
    for i in _indices(gst, "embed_"):
        sd[f"gst.embeds.{i}"] = _t(gst[f"embed_{i}"])
        for lin in ("W_query", "W_key", "W_value"):
            _dense(sd, f"gst.attentions.{i}.{lin}", gst[f"attention_{i}"][lin])
    if "speaker_adapter" in p:
        _dense(sd, "speaker_adapter.style_fuser", p["speaker_adapter"])
    return sd


def with_spk_state_from_jax(variables: dict) -> dict:
    """models/llm_v1_phoneme.py TransformerLMPhonemeWithSpk {'params',
    'batch_stats'} -> port state_dict (`lm.*`, `speaker_embed.*`)."""
    p = variables["params"]
    sd = {f"lm.{k}": v for k, v in v1_phoneme_lm_state_from_jax(p["lm"]).items()}
    spk = speaker_embedding_state_from_jax({
        "params": p["speaker_embed"],
        "batch_stats": variables["batch_stats"]["speaker_embed"]})
    sd.update((f"speaker_embed.{k}", v) for k, v in spk.items())
    return sd


# ---- the GAN discriminators --------------------------------------------------

def _wn_conv2d(sd, name, p):
    """A weight-normed flax Conv2d (v [kh, kw, in, out], g [1, 1, 1, out])
    -> torch's weight_g [out, 1, 1, 1] / weight_v [out, in, kh, kw]."""
    sd[f"{name}.weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1, 1))
    sd[f"{name}.weight_v"] = _t(np.asarray(p["v"]).transpose(3, 2, 0, 1))
    sd[f"{name}.bias"] = _t(p["bias"])


def _disc_conv1d(sd, name, p):
    if "sn_u" in p:          # spectral norm: weight_orig + the power-iteration buffers
        sd[f"{name}.weight_orig"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
        sd[f"{name}.weight_u"] = _t(p["sn_u"])
        sd[f"{name}.weight_v"] = _t(p["sn_v"])
        sd[f"{name}.bias"] = _t(p["bias"])
    else:
        _wn_conv(sd, name, p)


def _discriminators(sd, pre, p):
    """MultiPeriod / MultiResolution / MultiScale `discriminators_{i}`."""
    for i in _indices(p, "discriminators_"):
        d, name = p[f"discriminators_{i}"], f"{pre}discriminators.{i}"
        if any(k.startswith("band_convs_") for k in d):          # DiscriminatorR
            for key in d:
                if key.startswith("band_convs_"):
                    b, j = key[len("band_convs_"):].split("_")
                    _wn_conv2d(sd, f"{name}.band_convs.{b}.{j}", d[key])
            _wn_conv2d(sd, f"{name}.conv_post", d["conv_post"])
        elif np.ndim(d["conv_post"].get("v", d["conv_post"].get("kernel"))) == 4:  # P
            for j in _indices(d, "convs_"):
                _wn_conv2d(sd, f"{name}.convs.{j}", d[f"convs_{j}"])
            _wn_conv2d(sd, f"{name}.conv_post", d["conv_post"])
        else:                                                       # DiscriminatorS
            for j in _indices(d, "convs_"):
                _disc_conv1d(sd, f"{name}.convs.{j}", d[f"convs_{j}"])
            _disc_conv1d(sd, f"{name}.conv_post", d["conv_post"])


def discriminator_state_from_jax(params: dict) -> dict:
    """models/discriminator.py params (MultipleDiscriminator's `mpd` / `mrd`,
    or one Multi{Period,Resolution,Scale}Discriminator) -> port (and
    reference checkpoint) state_dict."""
    p = _root(params)
    sd: dict = {}
    if "mpd" in p:
        _discriminators(sd, "mpd.", p["mpd"])
        _discriminators(sd, "mrd.", p["mrd"])
    else:
        _discriminators(sd, "", p)
    return sd


# the registry kinds whose training forwards the port runs
TRAIN_CONVERTERS = {"qwen2lm": lm_state_from_jax,
                    "transformer_lm": transformer_lm_state_from_jax,
                    "qwen2lm_phoneme": phoneme_lm_state_from_jax,
                    "qwen2lm_phoneme_src": phoneme_lm_state_from_jax,
                    "qwen2lm_phoneme_src2": phoneme_lm_state_from_jax,
                    "qwen2lm_phoneme_multicode": multicode_lm_state_from_jax,
                    "transformer_lm_phoneme": v1_phoneme_lm_state_from_jax,
                    "flow": flow_state_from_jax, "flow_stream": flow_state_from_jax,
                    "flow_v1": flow_v1_state_from_jax, "hift": hift_state_from_jax,
                    "vits": vits_state_from_jax}


def train_state_from_jax(kind: str, tree: dict, lora_names=None) -> dict:
    """A JAX training tree of a registry `kind` -> the port module's
    parameter names: its params (a state dict to load), or a tree of the
    same layout, such as its gradients or an optimizer moment.  Every
    converter is a linear rearrangement, so a gradient tree carries across
    as the parameters do.  With `lora_names` (the port model's parameter
    names) the tree is a LoRA train state's ({flax path: {"a", "b"}}: the
    overlay, its gradients or a moment), mapped to train/lora.LoRAOverlay's
    parameter names (`a.<name>`, `b.<name>`, the name's dots as '/')."""
    if lora_names is not None:
        out = {}
        for name, ab in lora_overlay_from_jax(tree, lora_names).items():
            for k in ("a", "b"):
                out[f"{k}.{name.replace('.', '/')}"] = ab[k]
        return out
    return TRAIN_CONVERTERS[kind](tree)


# ---- LoRA overlays -----------------------------------------------------------

def _split_indices(segs: list) -> list:
    """`name_3` -> name, 3 (flax's list naming); port segments alike."""
    out = []
    for s in segs:
        m = re.fullmatch(r"(.+)_(\d+)", s)
        out += [m.group(1), m.group(2)] if m else [s]
    return out


def _common(a: list, b: list) -> int:
    """The length of the longest common subsequence of two segment lists."""
    row = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b):
            prev, row[j + 1] = row[j + 1], prev + 1 if x == y else max(row[j + 1], row[j])
    return row[-1]


def lora_overlay_from_jax(overlay, port_names) -> dict:
    """A JAX LoRA overlay ({flax path: {"a", "b"}}, or the path of a
    JAX-written lora.npz) -> {port parameter name: {"a", "b"}}.  The arrays
    carry over unchanged (train/lora.py's orientation).  A path maps to a
    name among `port_names` that ends in the path's module and leaf
    (kernel -> weight, v -> weight_v) and carries its indices in order
    (`layers_0` is `layers.0`); of those, to the one sharing the most of
    the path's other segments in order (flax `ff` is the port's
    `feed_forward`).  A path with no such name, or a tie, raises."""
    if isinstance(overlay, str):
        from cosyvoice_tpu_torch.train.lora import read_lora_npz

        overlay = read_lora_npz(overlay)
    names = [(n.split("."), _split_indices(n.split("."))) for n in port_names]
    out = {}
    for path, ab in overlay.items():
        segs = [p for p in path.split("/") if p]
        if segs[0] == "params":
            segs = segs[1:]
        leaf = {"kernel": "weight", "v": "weight_v"}.get(segs[-1])
        if leaf is None or len(segs) < 2:
            raise ValueError(f"{path}: LoRA adapters go on kernels and weight-normed v")
        want = _split_indices(segs[:-1]) + [leaf]
        index = [w for w in want if w.isdigit()]
        cands = [(_common(want, split), ".".join(n)) for n, split in names
                 if n[-2:] == [segs[-2], leaf] and [w for w in split if w.isdigit()] == index]
        best = max((c for c, _ in cands), default=0)
        hits = [name for c, name in cands if c == best]
        if len(hits) != 1:
            raise KeyError(f"{path}: {'no' if not hits else len(hits)} port parameters match "
                           f"{hits[:3]}")
        out[hits[0]] = {k: _t(v) if not isinstance(v, torch.Tensor) else v
                        for k, v in ab.items()}
    return out


# ---- the port's state_dicts -> JAX parameter trees --------------------------
#
# The inverses of lm_state_from_jax, flow_state_from_jax (the CosyVoice2 flow)
# and hift_state_from_jax, driven by the state dict's names (the reference
# checkpoint's): each rule maps a name pattern to a flax path and the layout
# change that undoes the forward map's.  A name no rule takes raises.

def _np(t) -> np.ndarray:
    t = t.detach().cpu() if isinstance(t, torch.Tensor) else t
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        t = t.float()
    return np.asarray(t)


_INV = {
    "id": lambda a: a,
    "T": lambda a: a.T,
    "conv": lambda a: a.transpose(2, 1, 0),               # [Cout, Cin, K] -> [K, Cin, Cout]
    "convT": lambda a: a.transpose(2, 0, 1)[::-1],        # [Cin, Cout, K] -> k-flipped [K, Cin, Cout]
    "g": lambda a: a.reshape(1, 1, -1),                   # weight_g [out, 1, 1] -> g [1, 1, out]
    "gT": lambda a: a.reshape(1, -1, 1),                  # a transposed conv's [in, 1, 1]
}


def _dense_rules(port: str, jax: str) -> list:
    return [(rf"{port}\.weight", rf"{jax}/kernel", "dense"),
            (rf"{port}\.bias", rf"{jax}/bias", "id"),
            (rf"{port}\.scale", rf"{jax}/scale", "id")]


def _ln_rules(port: str, jax: str) -> list:
    return [(rf"{port}\.weight", rf"{jax}/scale", "id"), (rf"{port}\.bias", rf"{jax}/bias", "id")]


def _conv_rules(port: str, jax: str, kind: str = "conv") -> list:
    return [(rf"{port}\.weight", rf"{jax}/kernel", kind), (rf"{port}\.bias", rf"{jax}/bias", "id")]


def _wn_rules(port: str, jax: str, kind: str = "conv") -> list:
    return [(rf"{port}\.weight_g", rf"{jax}/g", "gT" if kind == "convT" else "g"),
            (rf"{port}\.weight_v", rf"{jax}/v", kind),
            (rf"{port}\.bias", rf"{jax}/bias", "id")]


def _to_jax(sd: dict, rules: list, strict: bool = True) -> dict:
    """{name: tensor} -> {"params": nested flax dicts of numpy arrays} by
    `rules` [(name regex, path template or fn(match) -> path, layout)]; a
    name no rule takes raises, or with strict=False is left out (as the
    JAX package's importers leave out what they do not read)."""
    compiled = [(re.compile(p + "$"), path, how) for p, path, how in rules]
    tree: dict = {}
    for name, value in sd.items():
        for pat, path, how in compiled:
            m = pat.match(name)
            if m:
                break
        else:
            if strict:
                raise KeyError(f"no JAX path for {name}")
            print(f"  [to_jax] not a parameter of the JAX tree, left out: {name}")
            continue
        a = _np(value)
        if how == "dense":      # QDense int4 / int4xla kernels keep the JAX layout
            scale = sd.get(name[:-len("weight")] + "scale")
            how = "id" if scale is not None and scale.ndim == 2 else "T"
        elif how == "wn":       # a weight-normed conv's leaf, by its name
            how = {"g": "g", "v": "conv"}.get(name.rsplit("_", 1)[-1], "id")
        node = tree
        parts = (path(m) if callable(path) else m.expand(path)).split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        try:
            node[parts[-1]] = np.ascontiguousarray(_INV[how](a))
        except ValueError as e:
            raise ValueError(f"{name} {a.shape} by {pat.pattern} ({how}): {e}") from None
    return {"params": tree}


def lm_state_to_jax(sd: dict, strict: bool = True) -> dict:
    """A Qwen2LM state_dict (the port's, or a reference llm.pt) -> the JAX
    package's Qwen2LM params (the inverse of lm_state_from_jax)."""
    body, layer = r"llm\.model\.model\.", r"llm\.model\.model\.layers\.(\d+)\."
    return _to_jax(sd, [
        (body + r"embed_tokens\.weight", "llm/embed_tokens/embedding", "id"),
        (body + r"norm\.weight", "llm/norm", "id"),
        (layer + r"(input_layernorm|post_attention_layernorm)\.weight", r"llm/layers_\1/\2", "id"),
        *_dense_rules(layer + r"(?:self_attn|mlp)\.(\w+)", r"llm/layers_\1/\2"),
        (r"(llm_embedding|speech_embedding)\.weight", r"\1/embedding", "id"),
        *_dense_rules(r"llm_decoder", "llm_decoder"),
    ], strict)


def _conformer_layer_rules(port: str, jax: str) -> list:
    """One conformer layer's names (`port` a regex with the layer's groups)."""
    return [
        *_ln_rules(port + r"(norm_mha|norm_ff|norm_ff_macaron|norm_conv|norm_final)",
                   jax + r"/\3"),
        *_dense_rules(port + r"self_attn\.(linear_\w+)", jax + r"/self_attn/\3"),
        (port + r"self_attn\.(pos_bias_[uv])", jax + r"/self_attn/\3", "id"),
        *_dense_rules(port + r"feed_forward\.(w_[12])", jax + r"/ff/\3"),
        *_dense_rules(port + r"feed_forward_macaron\.(w_[12])", jax + r"/ff_macaron/\3"),
        *_dense_rules(port + r"spk_linear", jax + "/spk_linear"),
        *_conv_rules(port + r"conv_module\.(pointwise_conv1|depthwise_conv|pointwise_conv2)",
                     jax + r"/conv_module/\3"),
        *_ln_rules(port + r"conv_module\.norm", jax + "/conv_module/norm"),
    ]


def _estimator_rules(port: str, jax: str, causal: bool = True) -> list:
    level = port + r"(down|mid|up)_blocks\.(\d+)\."
    lvl = jax + r"/\1_\2"
    norm = "2" if causal else "1"
    rules = [*_dense_rules(port + r"time_mlp\.(linear_[12])", jax + r"/time_mlp/\1")]
    for blk in ("block1", "block2"):
        rules += _conv_rules(level + rf"0\.{blk}\.block\.0", lvl + f"_resnet/{blk}/conv")
        rules += _ln_rules(level + rf"0\.{blk}\.block\.{norm}", lvl + f"_resnet/{blk}/norm")
    rules += [*_dense_rules(level + r"0\.mlp\.1", lvl + "_resnet/mlp"),
              *_conv_rules(level + r"0\.res_conv", lvl + "_resnet/res_conv"),
              *_ln_rules(level + r"1\.(\d+)\.(norm[13])", lvl + r"_tb_\3/\4"),
              (level + r"1\.(\d+)\.attn1\.(to_[qkv])\.weight", lvl + r"_tb_\3/\4", "T"),
              *_dense_rules(level + r"1\.(\d+)\.attn1\.to_out\.0", lvl + r"_tb_\3/to_out"),
              *_dense_rules(level + r"1\.(\d+)\.ff\.net\.0\.proj", lvl + r"_tb_\3/ff_in"),
              *_dense_rules(level + r"1\.(\d+)\.ff\.net\.2", lvl + r"_tb_\3/ff_out")]
    resample = lambda m: f"{m.group(1)}_{m.group(2)}_" + (  # noqa: E731
        "downsample" if m.group(1) == "down" else "upsample")
    for sub, kinds in (("", ("down", "up")), ("conv/", ("down",)), ("conv/", ("up",))):
        how = "convT" if kinds == ("up",) and sub else "conv"
        pat = port + rf"({'|'.join(kinds)})_blocks\.(\d+)\.2\.{sub.replace('/', '.')}"
        rules += [(pat + "weight", lambda m, sub=sub: f"{jax}/{resample(m)}/{sub}kernel", how),
                  (pat + "bias", lambda m, sub=sub: f"{jax}/{resample(m)}/{sub}bias", "id")]
    rules += [*_conv_rules(port + r"final_block\.block\.0", jax + "/final_block/conv"),
              *_ln_rules(port + rf"final_block\.block\.{norm}", jax + "/final_block/norm"),
              *_conv_rules(port + r"final_proj", jax + "/final_proj")]
    return rules


def flow_state_to_jax(sd: dict, strict: bool = True) -> dict:
    """A CausalMaskedDiffWithXvec state_dict -> the JAX package's params
    (the inverse of flow_state_from_jax)."""
    enc = r"encoder\."
    return _to_jax(sd, [
        (r"input_embedding\.weight", "input_embedding/embedding", "id"),
        *_dense_rules(r"spk_embed_affine_layer", "spk_embed_affine_layer"),
        *_dense_rules(r"encoder_proj", "encoder_proj"),
        *_dense_rules(enc + r"(embed|up_embed)\.out\.0", r"encoder/\1/linear"),
        *_ln_rules(enc + r"(embed|up_embed)\.out\.1", r"encoder/\1/norm"),
        *_conv_rules(enc + r"pre_lookahead_layer\.(conv[12])", r"encoder/pre_lookahead_layer/\1"),
        *_conv_rules(enc + r"up_layer\.conv", "encoder/up_layer/conv"),
        *_ln_rules(enc + r"after_norm", "encoder/after_norm"),
        *_conformer_layer_rules(enc + r"(encoders|up_encoders)\.(\d+)\.", r"encoder/\1_\2"),
        *_estimator_rules(r"decoder\.estimator\.", "decoder/estimator"),
    ], strict)


def hift_state_to_jax(sd: dict, strict: bool = True) -> dict:
    """A HiFTGenerator state_dict (without `generator.`) -> the JAX
    package's params (the inverse of hift_state_from_jax)."""
    ups = len({k.split(".")[1] for k in sd if k.startswith("ups.")})
    nk = len({k.split(".")[1] for k in sd if k.startswith("resblocks.")}) // max(ups, 1)
    rb = lambda m: f"resblocks_{int(m.group(1)) // nk}_{int(m.group(1)) % nk}"  # noqa: E731

    def resblock(port: str, jax) -> list:
        """jax: a path prefix, or fn(match) -> one."""
        pre = jax if callable(jax) else (lambda m: m.expand(jax))
        return [
            (port + r"\.(convs[12])\.(\d+)\.(weight_g|weight_v|bias)",
             lambda m: f"{pre(m)}/{m.group(2)}_{m.group(3)}/"
             + {"weight_g": "g", "weight_v": "v", "bias": "bias"}[m.group(4)], "wn"),
            (port + r"\.activations([12])\.(\d+)\.alpha",
             lambda m: f"{pre(m)}/act{m.group(2)}_{m.group(3)}/alpha", "id")]

    rules = [*_wn_rules(r"(conv_pre|conv_post)", r"\1"),
             *_dense_rules(r"m_source\.l_linear", "m_source/l_linear"),
             (r"f0_predictor\.condnet\.(\d+)\.(weight_g|weight_v|bias)",
              lambda m: f"f0_predictor/conv_{int(m.group(1)) // 2}/"
              + {"weight_g": "g", "weight_v": "v", "bias": "bias"}[m.group(2)], "wn"),
             *_dense_rules(r"f0_predictor\.classifier", "f0_predictor/classifier"),
             *_wn_rules(r"ups\.(\d+)", r"ups_\1", "convT"),
             *_conv_rules(r"source_downs\.(\d+)", r"source_downs_\1"),
             *resblock(r"source_resblocks\.(\d+)", r"source_resblocks_\1"),
             *resblock(r"resblocks\.(\d+)", rb)]
    return _to_jax(sd, rules, strict)
