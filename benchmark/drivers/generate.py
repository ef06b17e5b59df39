"""Driver of `inference/generate.py:build_generate_fn`: the consistency
student's generation, one closed-loop client.

Set-up builds the kernels (the first run in a checkout compiles them into
its `build/`), makes the configuration's weights from the seed on the card
and loads them strictly into `Pipeline.create`'s modules, and calls the
entry once per prompt length the mix sends (twice for the first). A request
is the mix's prompts with fresh initial noise; it is done when its
waveforms are on the host as float32. The check regenerates the inputs of
a sample of the window's requests, drawn from the seed (`harness.Sample`),
and runs the plain float32 reference on them; each clip's relative L2
distance to the reference is taken, and the numbers that the cell's limits
name (the worst clip, the median clip, the worst clip over the reference's
own bfloat16 probe: `readings`) must each be under their limit."""

from __future__ import annotations

import sys

import torch

from benchmark import harness
from benchmark.hooks import StageTimer
from benchmark.reference import generate as reference
from benchmark.generator import Traffic
from benchmark.weights import make_weights

TEACHER = False


def entry(pipe, spec: dict):
    from consistencytta_torch.inference.generate import GenerateConfig, build_generate_fn

    return build_generate_fn(pipe, GenerateConfig(num_steps=spec["entry"]["num_steps"]))


def roles():
    from consistencytta_torch.models.pipeline import STUDENT_ROLES

    return STUDENT_ROLES


def unet_of(pipe):
    return pipe.unets["student_ema"]


def reference_call(models, run: harness.Run, req, noise):
    return reference.student(models, run.pipeline, req.ids, req.mask, noise, req.guidance)


def _tensor(a, dev):
    return torch.as_tensor(a, device=dev)


def setup(run: harness.Run, driver=None) -> None:
    """`driver` is the module whose entry, roles, UNet and reference to
    take: this one, or one that reuses this set-up (teacher.py)."""
    d = driver or sys.modules[__name__]
    from consistencytta_torch.configs import PipelineConfig
    from consistencytta_torch.models.pipeline import Pipeline

    if run.cuda:
        from consistencytta_torch.ops import _build

        _build.build()
    config = PipelineConfig.from_dict(run.pipeline)
    weights = make_weights(run.pipeline, run.seed, run.device, run.dtype, d.TEACHER)
    pipe = Pipeline.create(config, dtype=run.dtype, device=run.device, seed=0, roles=d.roles())
    for name, module in (("t5", pipe.t5), ("unet", d.unet_of(pipe)), ("vae", pipe.vae),
                         ("vocoder", pipe.vocoder)):
        module.load_state_dict(weights[name], strict=True)
    del weights
    fn = d.entry(pipe, run.cell.spec)
    traffic = Traffic(run.cell.traffic, run.seed, config.t5.vocab_size)
    shape = pipe.latent_shape(traffic.batch)

    def call(i, req=None):
        req = req or traffic.request(i)
        noise = traffic.noise(i, shape, run.device)
        wav = fn(req.ids, req.mask, req.uncond_ids, req.uncond_mask, req.guidance, noise=noise)
        return wav.to("cpu", torch.float32), req.ids.shape[0], req.length

    for k, n in enumerate(traffic.lengths):
        for _ in range(2 if k == 0 else 1):
            call(-1, traffic.request(-1, n))
    if run.trace:
        run.timer = StageTimer(run.device)
        run.timer.stage("t5", pipe.t5)
        run.timer.stage("unet", d.unet_of(pipe))
        run.timer.stage("vae_decode", pipe.vae.post_quant_conv, pipe.vae.decoder)
        run.timer.stage("vocoder", pipe.vocoder)
    run.sample = harness.Sample(run.seed, run.cell.spec["check"]["requests"])
    run.state.update(pipe=pipe, fn=fn, traffic=traffic, call=call, shape=shape, driver=d)


def window(run: harness.Run) -> None:
    harness.closed_loop(run, run.state["call"], run.cell.spec["trace"]["requests"])


def free(run: harness.Run) -> None:
    for key in ("pipe", "fn", "call"):
        run.state.pop(key, None)


def readings(run: harness.Run, requests, outputs, quant=None, probe: bool = False) -> dict:
    """Relative L2 distance of each clip of `outputs` (request -> host
    waveforms) from the float32 reference: {"worst": the largest, "median":
    the median clip's}. With `quant` the reference itself runs through that
    rounding and is judged instead (the control). With `probe` the reference
    also runs with every product's operands and outputs rounded to bfloat16,
    and "worst_over_bf16" is the largest ratio of a clip's distance to that
    probe's distance for the same clip: the seed's own sensitivity to
    rounding divided out. A clip of another length than the reference's
    reads infinity."""
    from benchmark.reference.layers import bf16_round, fake_quant

    d = run.state["driver"]
    traffic = run.state["traffic"]
    weights = make_weights(run.pipeline, run.seed, run.device, run.dtype, d.TEACHER)
    models = reference.build(run.pipeline, weights, run.device, d.TEACHER)
    del weights

    def ref_call(req, noise, rounding):
        for m in models.modules():
            fake_quant(m, rounding)
        return d.reference_call(models, run, req, noise).cpu()

    rels, probes = [], []
    for i in requests:
        req = traffic.request(i)
        req = type(req)(i, *(_tensor(a, run.device) for a in
                             (req.ids, req.mask, req.uncond_ids, req.uncond_mask)), req.guidance)
        noise = traffic.noise(i, run.state["shape"], run.device)
        ref = ref_call(req, noise, None)
        got = outputs[i] if quant is None else ref_call(req, noise, quant)
        if probe:
            near = ref_call(req, noise, bf16_round)
            probes += ((near - ref).norm(dim=1) / ref.norm(dim=1)).tolist()
        if got.shape != ref.shape:
            rels += [float("inf")] * ref.shape[0]
            continue
        rels += ((got - ref).norm(dim=1) / ref.norm(dim=1)).tolist()
    del models
    harness.free_cuda(run)
    rels = torch.tensor(rels, dtype=torch.float64)
    bad = bool(torch.isnan(rels).any())
    value = {"worst": float("nan") if bad else float(rels.max()),
             "median": float("nan") if bad else float(rels.median())}
    if probe:
        ratio = rels / torch.tensor(probes, dtype=torch.float64)
        value["worst_over_bf16"] = float("nan") if bad else float(ratio.max())
    return value


NAMES = {"worst": "worst_clip_rel_l2", "median": "median_clip_rel_l2",
         "worst_over_bf16": "worst_clip_over_bf16_probe"}


def probed(limits: dict) -> bool:
    return "worst_over_bf16" in limits


def check(run: harness.Run):
    spec = run.cell.spec["check"]
    value = readings(run, run.sample.picked(), run.sample.outputs, probe=probed(spec["limit"]))
    return [harness.Check(NAMES[k], value[k], spec["limit"][k]) for k in spec["limit"]]
