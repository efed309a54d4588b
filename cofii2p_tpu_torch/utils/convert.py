"""Carry weights from the JAX package into the port.

:func:`jax_to_state_dict` maps a flax param tree and batch stats (nested
dicts of numpy arrays) to the reference's torch state-dict layout, with the
mapping table of cofii2p_tpu/utils/checkpoint.py::export_t7: conv kernels
HWIO -> OIHW, dense kernels (in, out) -> (out, in).  The port's modules
carry the reference's names, so :func:`load_jax_params` is a strict
``load_state_dict``, and a reference ``.t7`` state dict can later load the
same way.
"""

from __future__ import annotations

import numpy as np
import torch


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def jax_to_state_dict(params: dict, batch_stats: dict) -> dict:
    """The reference state dict of a flax param tree (or of a gradient tree
    of the same structure, with ``batch_stats`` empty: then the BatchNorm
    running statistics are left out)."""
    sd = {}

    def put(name, arr, kind="raw"):
        arr = np.asarray(arr, np.float32)
        if kind == "conv":
            arr = arr.transpose(3, 2, 0, 1)
        elif kind == "linear":
            arr = arr.T
        sd[name] = torch.tensor(arr)  # a copy: the input may be a read-only view

    # image encoder
    put("img_encoder.backbone.conv1.weight", _get(params, ("img_encoder", "conv1", "Conv_0", "kernel")), "conv")
    enc = params["img_encoder"]
    s = 1
    while f"layer{s}_0" in enc:
        b = 0
        while f"layer{s}_{b}" in enc:
            fb, tb = ("img_encoder", f"layer{s}_{b}"), f"img_encoder.backbone.layer{s}.{b}."
            put(tb + "conv1.weight", _get(params, fb + ("conv1", "Conv_0", "kernel")), "conv")
            put(tb + "conv2.weight", _get(params, fb + ("conv2", "Conv_0", "kernel")), "conv")
            if "downsample" in enc[f"layer{s}_{b}"]:
                put(tb + "downsample.0.weight", _get(params, fb + ("downsample", "Conv_0", "kernel")), "conv")
            b += 1
        s += 1

    # pc feature head
    for tidx, fname in (("0", "Linear_0"), ("3", "Linear_1"), ("6", "Linear_2")):
        put(f"pc_feature_layer.{tidx}.weight", _get(params, ("pc_feature_layer", fname, "Dense_0", "kernel")), "linear")
    for tidx, fname in (("1", "LayerNorm_0"), ("4", "LayerNorm_1")):
        put(f"pc_feature_layer.{tidx}.weight", _get(params, ("pc_feature_layer", fname, "scale")))
        put(f"pc_feature_layer.{tidx}.bias", _get(params, ("pc_feature_layer", fname, "bias")))

    # score heads: 1x1 convs, Conv1d layout (O, I, 1) / Conv2d (O, I, 1, 1)
    for head, rank in (("pc_score_layer", 3), ("img_score_layer", 4)):
        for fidx, tidx in (("Linear_0", "0"), ("Linear_1", "3"), ("Linear_2", "6")):
            w = _get(params, (head, fidx, "Dense_0", "kernel")).T
            put(f"{head}.{tidx}.weight", w.reshape(w.shape + (1,) * (rank - 2)))

    # transformer
    for i in range(len(params["transformer"])):
        fb, tb = ("transformer", f"layer{i}"), f"transformer.layers.{i}."
        for nm in ("q_proj", "k_proj", "v_proj", "merge"):
            put(tb + nm + ".weight", _get(params, fb + (nm, "kernel")), "linear")
        put(tb + "mlp.0.weight", _get(params, fb + ("mlp1", "kernel")), "linear")
        put(tb + "mlp.2.weight", _get(params, fb + ("mlp2", "kernel")), "linear")
        for nm in ("norm1", "norm2"):
            put(tb + nm + ".weight", _get(params, fb + (nm, "scale")))
            put(tb + nm + ".bias", _get(params, fb + (nm, "bias")))

    # image upsample decoders (BatchNorm running statistics from batch_stats)
    for up in ("img_upsample_1", "img_upsample_2"):
        for f_res, t_res in (("res1", "conv.0"), ("res2", "conv.1")):
            fb, tb = (up, f_res), f"{up}.{t_res}."
            put(tb + "conv1.weight", _get(params, fb + ("conv1", "Conv_0", "kernel")), "conv")
            put(tb + "conv2.weight", _get(params, fb + ("conv2", "Conv_0", "kernel")), "conv")
            put(tb + "conv_skip.0.weight", _get(params, fb + ("conv_skip", "Conv_0", "kernel")), "conv")
            for fbn, tbn in (("bn1", "bn1"), ("bn2", "bn2"), ("bn_skip", "conv_skip.1")):
                put(tb + tbn + ".weight", _get(params, fb + (fbn, "scale")))
                put(tb + tbn + ".bias", _get(params, fb + (fbn, "bias")))
                if batch_stats:  # empty when mapping a gradient tree
                    put(tb + tbn + ".running_mean", _get(batch_stats, fb + (fbn, "mean")))
                    put(tb + tbn + ".running_var", _get(batch_stats, fb + (fbn, "var")))
                    sd[tb + tbn + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    # KPConv FPN
    pe, fpe = "pc_encoder.", ("pc_encoder",)
    fpn = params["pc_encoder"]

    def norm(fpath, tpath):
        # 'gn': flax's PointGroupNorm_0 into the reference's GroupNorm
        # wrapper (<tpath>.norm.weight); 'ln': TorchLayerNorm_0's LayerNorm
        # into the nn.LayerNorm the reference's get_norm puts at <tpath>
        block = params
        for p in fpath:
            block = block[p]
        if "TorchLayerNorm_0" in block:
            put(tpath + ".weight", _get(params, fpath + ("TorchLayerNorm_0", "LayerNorm_0", "scale")))
            put(tpath + ".bias", _get(params, fpath + ("TorchLayerNorm_0", "LayerNorm_0", "bias")))
        else:
            put(tpath + ".norm.weight", _get(params, fpath + ("PointGroupNorm_0", "scale")))
            put(tpath + ".norm.bias", _get(params, fpath + ("PointGroupNorm_0", "bias")))

    def unary(fpath, tpath, with_norm=True):
        put(tpath + "mlp.weight", _get(params, fpath + ("mlp", "Dense_0", "kernel")), "linear")
        put(tpath + "mlp.bias", _get(params, fpath + ("mlp", "Dense_0", "bias")))
        if with_norm:
            norm(fpath, tpath + "norm")

    def kpconv(fpath, tpath):
        for nm in ("weights", "kernel_points", "bias"):
            put(tpath + nm, _get(params, fpath + (nm,)))

    kpconv(fpe + ("encoder1_1", "KPConv"), pe + "encoder1_1.KPConv.")
    norm(fpe + ("encoder1_1",), pe + "encoder1_1.norm")
    for nm in ["encoder1_2"] + [f"encoder{st}_{i}" for st in range(2, 6) for i in range(1, 4)]:
        fb, tb = fpe + (nm,), pe + nm + "."
        if "unary1" in fpn[nm]:
            unary(fb + ("unary1",), tb + "unary1.")
        kpconv(fb + ("KPConv",), tb + "KPConv.")
        norm(fb, tb + "norm_conv")
        unary(fb + ("unary2",), tb + "unary2.")
        if "unary_shortcut" in fpn[nm]:
            unary(fb + ("unary_shortcut",), tb + "unary_shortcut.")
    unary(fpe + ("decoder4",), pe + "decoder4.")
    unary(fpe + ("decoder3",), pe + "decoder3.")
    put(pe + "decoder2.mlp.weight", _get(params, fpe + ("decoder2", "Dense_0", "kernel")), "linear")
    put(pe + "decoder2.mlp.bias", _get(params, fpe + ("decoder2", "Dense_0", "bias")))
    return sd


def load_jax_params(model: torch.nn.Module, params: dict, batch_stats: dict) -> torch.nn.Module:
    """Fill ``model`` (the port's CoFiI2P) from a flax param tree and batch
    stats of numpy arrays; every tensor of the model must be covered."""
    model.load_state_dict(jax_to_state_dict(params, batch_stats), strict=True)
    return model


def randomize(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Seeded random weights: weight matrices and kernels uniform in
    +-1/sqrt(fan_in), norm scales 1, biases small, running stats (0, 1);
    kernel points stay the canonical disposition."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                # KPConv weights (K, Cin, Cout) use 1/sqrt(Cin*Cout) as the
                # JAX init does; others (out, in, ...) their fan-in
                fan_in = int(np.prod(p.shape[1:]))
                bound = 1.0 / np.sqrt(fan_in)
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
            elif name.endswith("bias"):
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * 0.01)
            else:
                p.fill_(1.0)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.zero_()
            elif name.endswith("running_var"):
                buf.fill_(1.0)
    return model


def jittered_kernel_points(kp: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``kp`` (K, 3) rotated about a random axis and jittered by 1% of its
    radius, as the reference disposes each KPConv's kernel points."""
    axis = torch.randn(3, generator=generator, dtype=torch.float64)
    axis = axis / axis.norm()
    th = float(torch.rand((), generator=generator, dtype=torch.float64)) * 2 * np.pi
    k = torch.tensor([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]], [-axis[1], axis[0], 0.0]],
                     dtype=torch.float64)
    rot = torch.eye(3, dtype=torch.float64) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)
    kp64 = kp.detach().cpu().double()
    noise = torch.randn(kp.shape, generator=generator, dtype=torch.float64) * 0.01 * kp64.norm(dim=-1).max()
    return (kp64 @ rot.T + noise).to(kp.dtype).to(kp.device)


def jitter_kernel_points(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Give every KPConv of ``model`` its own :func:`jittered_kernel_points`,
    as a reference checkpoint carries them."""
    with torch.no_grad():
        for name, kp in model.named_buffers():
            if name.endswith("kernel_points"):
                kp.copy_(jittered_kernel_points(kp, generator))
    return model
