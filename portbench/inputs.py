"""The inputs every cell hands to the program and to its reference alike:
weights and data, made by the benchmark from the seed.  Nothing here
imports the program."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["seed_rng", "resnet_weights", "decoder_shapes", "decoder_weights",
           "image_batches"]


def seed_rng(seed: int, stream: int = 0) -> np.random.Generator:
    """numpy's generator for `--seed` (any whole number) and a stream."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def torch_seed(seed: int, stream: int = 0) -> int:
    return (int(seed) * 1_000_003 + stream) & (2 ** 63 - 1)


# ------------------------------------------------------------------ ResNet

def resnet_blocks(layers=(3, 4, 6, 3), widths=(64, 128, 256, 512),
                  expansion: int = 4) -> List[Tuple[int, int, int, bool]]:
    """(cin, planes, stride, downsample) of each bottleneck, in order."""
    out, cin = [], widths[0]
    for stage, (planes, n) in enumerate(zip(widths, layers)):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            out.append((cin, planes, stride, i == 0))
            cin = planes * expansion
    return out


def resnet_weights(cfg: dict) -> List[np.ndarray]:
    """The float weights of the configuration's ResNet in the order they are
    drawn: for each conv its HWIO weight (He normal), then its batch norm's
    mean, var, gamma, beta; at the end the classifier's [C, classes] weight
    and its bias (zeros).  The convs come stem first, then each bottleneck's
    1x1, 3x3, 1x1 and, where it has one, its projection shortcut.  Drawn
    with numpy from `cfg["weight_seed"]`, the recipe the checked-in scale
    table was calibrated for (the port's `models.build_resnet` draws the
    same)."""
    rng = np.random.default_rng(int(cfg["weight_seed"]))
    out: List[np.ndarray] = []

    def conv(k, cin, cout):
        w = rng.normal(0.0, np.sqrt(2.0 / (k * k * cin)), (k, k, cin, cout))
        out.append(w.astype(np.float32))
        out.append(rng.normal(0.0, 0.1, (cout,)).astype(np.float32))
        out.append(rng.uniform(0.5, 1.5, (cout,)).astype(np.float32))
        out.append(rng.uniform(0.5, 1.5, (cout,)).astype(np.float32))
        out.append(rng.normal(0.0, 0.1, (cout,)).astype(np.float32))

    exp = int(cfg["expansion"])
    conv(int(cfg["stem_kernel"]), 3, int(cfg["widths"][0]))
    for cin, planes, _, down in resnet_blocks(cfg["layers"], cfg["widths"],
                                              exp):
        conv(1, cin, planes)
        conv(3, planes, planes)
        conv(1, planes, planes * exp)
        if down:
            conv(1, cin, planes * exp)
    c = int(cfg["widths"][-1]) * exp
    n = int(cfg["num_classes"])
    out.append(rng.normal(0.0, np.sqrt(1.0 / c), (c, n)).astype(np.float32))
    out.append(np.zeros((n,), np.float32))
    return out


def image_batches(seed: int, n: int, batch: int, size: int,
                  device) -> List[torch.Tensor]:
    """`n` NHWC float32 batches of standard-normal pixels, each value a
    bfloat16 number (so that a bf16 net reads them as they are), made on
    the device from the seed."""
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, 1))
    return [torch.randn((batch, size, size, 3), generator=g, device=device,
                        dtype=torch.float32).to(torch.bfloat16)
            .to(torch.float32) for _ in range(n)]


# ---------------------------------------------------------------- decoder

def decoder_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, std) of each random weight of the llama-class decoder,
    in the port's names (`models.transformer.make_transformer_params`);
    the RMSNorm gains, all ones, are not listed."""
    E, H, Hkv = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    D = E // H
    F, V = cfg["intermediate_size"], cfg["vocab_size"]
    out = [("embed", (V, E), 0.02)]
    for i in range(cfg["num_hidden_layers"]):
        out += [(f"l{i}.wq", (E, H * D), E ** -0.5),
                (f"l{i}.wk", (E, Hkv * D), E ** -0.5),
                (f"l{i}.wv", (E, Hkv * D), E ** -0.5),
                (f"l{i}.wo", (H * D, E), (H * D) ** -0.5),
                (f"l{i}.mlp_up", (E, F), E ** -0.5),
                (f"l{i}.mlp_gate", (E, F), E ** -0.5),
                (f"l{i}.mlp_down", (F, E), F ** -0.5)]
    out.append(("lm_head", (E, V), E ** -0.5))
    return out


def norm_names(cfg: dict) -> List[str]:
    return ([f"l{i}.ln{j}_g" for i in range(cfg["num_hidden_layers"])
             for j in (1, 2)] + ["lnf_g"])


def _decoder_buffer(cfg: dict, seed: int, device) -> torch.Tensor:
    """Every random weight of the decoder, one after another in
    `decoder_shapes` order, scaled: one call of a seeded generator on the
    device."""
    shapes = decoder_shapes(cfg)
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, 2))
    buf = torch.randn((total,), generator=g, device=device,
                      dtype=torch.float32)
    at = 0
    for _, shape, std in shapes:
        n = int(np.prod(shape))
        buf[at:at + n].mul_(std)
        at += n
    return buf


def _split(cfg: dict, flat, ones):
    out, at = {}, 0
    for name, shape, _ in decoder_shapes(cfg):
        n = int(np.prod(shape))
        out[name] = flat[at:at + n].reshape(shape)
        at += n
    for name in norm_names(cfg):
        out[name] = ones()
    return out


def decoder_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of the decoder as float32 on `device`: normal draws at
    `make_transformer_params`'s scales and the norm gains (ones).  The same
    seed gives the same weights on the same device."""
    E = cfg["hidden_size"]
    return _split(cfg, _decoder_buffer(cfg, seed, device), lambda: torch.ones(
        (E,), dtype=torch.float32, device=device))


def decoder_weights_numpy(cfg: dict, seed: int,
                          device) -> Dict[str, np.ndarray]:
    """`decoder_weights`, made on `device` and copied to the host in one
    transfer: the float32 arrays the program's scheduler takes."""
    flat = _decoder_buffer(cfg, seed, device).cpu().numpy()
    E = cfg["hidden_size"]
    return _split(cfg, flat, lambda: np.ones((E,), np.float32))
