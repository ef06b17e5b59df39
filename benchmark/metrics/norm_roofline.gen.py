"""norm_roofline.gen: the port's normalisation kernels (`ctta_norm_`,
consistencytta_torch/ops/norm.py) in the traced requests: the bound of
every GroupNorm, LayerNorm and RMSNorm of each T5, UNet and VAE-decode call
the stage hooks saw, at its batch (`benchmark/norms.py`: one read and one
write of each element in the configuration's dtype, the affine once, at
the card's memory rate), over those kernels' summed device time in the
trace, in %. None where no such kernel ran, or where the mix's prompts
differ in length (T5's tokens are not known per call)."""

import torch

from benchmark import norms
from benchmark.reading import roofline_pct, traced_calls

LAUNCH_NAME = "ctta_norm_"


def read(run):
    lengths = run.cell.traffic["text_len"]
    if lengths["min"] != lengths["max"]:
        return None
    itemsize = torch.empty((), dtype=run.dtype).element_size()
    bound = sum(norms.norm_bound_s(norms.stage_norms(run.pipeline, stage, lengths["max"]), b,
                                   itemsize)
                for stage in ("t5", "unet", "vae_decode") for b in traced_calls(run, stage))
    return roofline_pct(run, LAUNCH_NAME, bound) if bound else None
