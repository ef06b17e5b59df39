"""The normalisation layers' share of a call, from the configuration's shapes:
the elements each GroupNorm, LayerNorm and RMSNorm of a T5 call, a UNet query
and a VAE decode normalises, and the least time the card could take for them
(each element read and written once in the served dtype, the float32 affine
read once, at the card's memory rate). The enumeration mirrors the
reference's modules (`benchmark/reference/`): the UNet's resnets (two
GroupNorms each, the up blocks' over the concatenated skip), each
transformer's GroupNorm and three LayerNorms, `conv_norm_out`; the decoder's
resnets, mid attention and `norm_out`; T5's two RMSNorms a layer and the
final one."""

from __future__ import annotations

from typing import List, Tuple

from benchmark import yardstick

Norm = Tuple[int, int]  # (elements a sample, float32 affine parameters)


def _gn(channels: int, pixels: int) -> Norm:
    return channels * pixels, 2 * channels


def unet_norms(unet: dict, latent: dict) -> List[Norm]:
    """The norms of one UNet query, a sample: down blocks, mid block, up
    blocks, then conv_norm_out."""
    chs, heads, per = unet["block_out_channels"], unet["attention_head_dim"], unet["layers_per_block"]
    n = len(chs)
    pixels = lambda i: latent["t"] * latent["f"] // 4 ** i
    out: List[Norm] = []

    def resnet(cin, cout, i):
        out.extend((_gn(cin, pixels(i)), _gn(cout, pixels(i))))

    def transformer(ch, h, i):
        width = h * (ch // h)
        out.append(_gn(ch, pixels(i)))
        out.extend([(pixels(i) * width, 2 * width)] * 3)

    prev, skips = chs[0], [chs[0]]
    for i, kind in enumerate(unet["down_block_types"]):
        for j in range(per):
            resnet(prev if j == 0 else chs[i], chs[i], i)
            if kind == "CrossAttnDownBlock2D":
                transformer(chs[i], heads[i], i)
            skips.append(chs[i])
        prev = chs[i]
        if i != n - 1:
            skips.append(prev)
    resnet(prev, prev, n - 1)
    transformer(prev, heads[-1], n - 1)
    resnet(prev, prev, n - 1)
    for i, kind in enumerate(unet["up_block_types"]):
        level = n - 1 - i
        for _ in range(per + 1):
            resnet(prev + skips.pop(), chs[level], level)
            prev = chs[level]
            if kind == "CrossAttnUpBlock2D":
                transformer(chs[level], heads[level], level)
    out.append(_gn(chs[0], pixels(0)))
    return out


def vae_decode_norms(vae: dict, latent: dict) -> List[Norm]:
    """The norms of one decoder call, a sample: the mid block (two resnets,
    the attention's GroupNorm), each level's resnets, then norm_out."""
    ch, mults = vae["base_channels"], vae["ch_mult"]
    pixels = lambda i: latent["t"] * latent["f"] * 4 ** (len(mults) - 1 - i)
    cin, top = ch * mults[-1], len(mults) - 1
    out = [_gn(cin, pixels(top))] * 5
    for i in reversed(range(len(mults))):
        for _ in range(vae["num_res_blocks"] + 1):
            out.extend((_gn(cin, pixels(i)), _gn(ch * mults[i], pixels(i))))
            cin = ch * mults[i]
    out.append(_gn(cin, pixels(0)))
    return out


def t5_norms(t5: dict, tokens: int) -> List[Norm]:
    """The RMSNorms of one T5 call over `tokens` tokens, a sample."""
    return [(tokens * t5["d_model"], t5["d_model"])] * (2 * t5["num_layers"] + 1)


def stage_norms(pipeline: dict, stage: str, tokens: int) -> List[Norm]:
    if stage == "t5":
        return t5_norms(pipeline["t5"], tokens)
    if stage == "unet":
        return unet_norms(pipeline["unet"], pipeline["latent"])
    if stage == "vae_decode":
        return vae_decode_norms(pipeline["vae"], pipeline["latent"])
    raise ValueError(f"no norms counted for stage {stage!r}")


def norm_bound_s(norms: List[Norm], batch: int, itemsize: int) -> float:
    """The least seconds for `norms` at `batch`: each element read and
    written once at `itemsize` bytes, each norm's affine read once."""
    nbytes = sum(2 * batch * e * itemsize + 4 * a for e, a in norms)
    return yardstick.bound_s(0.0, nbytes)
