"""Evaluation harness: a directory of wavs in, a metric dict out.

The port's counterpart of consistencytta_tpu/evaluation/harness.py (the
EvaluationHelper of audioldm_eval/eval.py:59-349): it checks the generated
and reference file sets' intersection, extracts Cnn14 features (FD, KL,
ISc, KID), VGGish embeddings (FAD) and CLAP embeddings (CLAP scores),
computes PSNR and SSIM on the normalised log-mels and LSD and SSIM-STFT on
the waveforms, and writes `*_evaluation_results.json`.

Each backbone is used only where its checkpoint file is there; a missing
one gives NaN for its metrics, with a warning, as in the JAX package. The
backbones and the eval mels run on `device`, the card unless the caller
passes "cpu"; the metric math runs on the host. The eval mels go through
kernel K4 (the 512-point STFT) on the card, in one launch for up to
MEL_BATCH files of one length, where the JAX harness makes one call a
file; each row equals the per-file result.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from consistencytta_torch.evaluation import metrics as M
from consistencytta_torch.evaluation.mels import (
    eval_mel_frontend, load_wav_16k, normalized_logmel,
)
from consistencytta_torch.utils import resolve_device

MEL_BATCH = 32  # files a K4 launch takes: a generate batch's worth (~50 MB at 10 s)
RESULT_KEYS = [
    "frechet_distance", "frechet_audio_distance", "lsd", "psnr",
    "kullback_leibler_divergence_sigmoid", "kullback_leibler_divergence_softmax",
    "ssim", "ssim_stft", "inception_score_mean", "inception_score_std",
    "kernel_inception_distance_mean", "kernel_inception_distance_std",
    "gt_text_clap_score", "gen_text_clap_score", "gen_gt_clap_score",
]


def _list_wavs(directory: str) -> List[str]:
    return sorted(os.path.join(directory, f) for f in os.listdir(directory) if f.endswith(".wav"))


def batched_logmels(wavs: List[np.ndarray], frontend,
                    batch: int = MEL_BATCH) -> List[np.ndarray]:
    """`normalized_logmel` of each waveform, files of one length in batches
    of up to `batch` rows (one frontend launch each), in input order."""
    by_length: Dict[int, List[int]] = {}
    for i, w in enumerate(wavs):
        by_length.setdefault(len(w), []).append(i)
    out: List[Optional[np.ndarray]] = [None] * len(wavs)
    for idxs in by_length.values():
        for start in range(0, len(idxs), batch):
            sel = idxs[start : start + batch]
            for i, mel in zip(sel, normalized_logmel(np.stack([wavs[i] for i in sel]), frontend)):
                out[i] = mel
    return out


@dataclass
class EvaluationHelper:
    """main(generated_dir, reference_dir, captions=...) -> metric dict.
    `seconds` holds the seconds of each part of the last `main` call."""

    sampling_rate: int = 16000
    cnn14_checkpoint: Optional[str] = "ckpt/Cnn14_16k_mAP=0.438.pth"
    vggish_checkpoint: Optional[str] = "ckpt/vggish.pth"
    clap_checkpoint: Optional[str] = "ckpt/music_audioset_epoch_15_esc_90.14.pt"
    target_length_centisec: int = 1000  # 10-s crops (eval.py WaveDataset)
    kid_subsets: int = 100
    device: str = "cuda"
    seconds: Dict[str, float] = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # the eval-specific mel frontend: 512-point, fmin 50 (eval.py:90-93)
        self.eval_frontend = eval_mel_frontend(self.device)
        self._cnn14 = None

    # -- backbones ----------------------------------------------------------

    def _get_cnn14(self):
        if self._cnn14 is None and self.cnn14_checkpoint and os.path.exists(
                self.cnn14_checkpoint):
            from consistencytta_torch.evaluation.panns import load_cnn14

            self._cnn14 = load_cnn14(self.cnn14_checkpoint, self.device)
        return self._cnn14

    def cnn14_features(self, paths: List[str], batch: int = 8):
        model = self._get_cnn14()
        if model is None:
            return None
        # batch only equal-length clips: zero-padding a ragged batch adds
        # silent frames that shift the time max / mean pooling. The reference
        # runs batch 1 (eval.py:205-209), so features must be faithful to
        # each clip's length. Results reassemble in input order.
        wavs = [load_wav_16k(p, self.target_length_centisec) for p in paths]
        buckets: Dict[int, List[int]] = {}
        for i, w in enumerate(wavs):
            buckets.setdefault(len(w), []).append(i)
        emb_out = [None] * len(paths)
        logit_out = [None] * len(paths)
        with torch.no_grad():
            for _, idxs in sorted(buckets.items()):
                for start in range(0, len(idxs), batch):
                    sel = idxs[start : start + batch]
                    x = torch.from_numpy(np.stack([wavs[i] for i in sel])).to(self.device)
                    out = model(x)
                    e, l = out["2048"].cpu().numpy(), out["logits"].cpu().numpy()
                    for j, i in enumerate(sel):
                        emb_out[i] = e[j]
                        logit_out[i] = l[j]
        return np.stack(emb_out), np.stack(logit_out)

    # -- main ---------------------------------------------------------------

    def file_intersection(self, dir1: str, dir2: str, threshold: float = 0.99):
        names1 = {os.path.basename(p) for p in _list_wavs(dir1)}
        names2 = {os.path.basename(p) for p in _list_wavs(dir2)}
        inter = names1 & names2
        same = (
            len(inter) / max(len(names1), 1) > threshold
            and len(inter) / max(len(names2), 1) > threshold
        )
        return same, sorted(inter)

    def load_mel_artifact(self, mel_path: Optional[str]) -> Dict[str, np.ndarray]:
        """The all_mels.npz that the test-set CLI writes (the reference's
        all_mels.pt artifact, inference.py:222-232) as a name -> mel dict.
        Mels stored at another crop length than this helper's are rejected
        (and recomputed), so that a stale artifact cannot skew PSNR / SSIM."""
        if not mel_path or not os.path.exists(mel_path):
            return {}
        with np.load(mel_path, allow_pickle=False) as z:
            if int(z["target_centisec"]) != self.target_length_centisec:
                print(
                    f"WARNING: {mel_path} stores mels cropped at "
                    f"{int(z['target_centisec'])} centisec, helper expects "
                    f"{self.target_length_centisec}; recomputing mels"
                )
                return {}
            names = [str(n) for n in z["names"]]
            return dict(zip(names, z["mels"]))

    def main(
        self,
        generated_dir: str,
        reference_dir: str,
        captions: Optional[Dict[str, str]] = None,
        limit_num: Optional[int] = None,
        mel_path: Optional[str] = None,
    ) -> Dict[str, float]:
        seconds = self.seconds = {}
        clock = time.perf_counter
        same_name, shared = self.file_intersection(generated_dir, reference_dir)
        if limit_num:
            shared = shared[:limit_num]
        stored_mels = self.load_mel_artifact(mel_path)

        gen_paths = ([os.path.join(generated_dir, n) for n in shared] if same_name
                     else _list_wavs(generated_dir))
        ref_paths = ([os.path.join(reference_dir, n) for n in shared] if same_name
                     else _list_wavs(reference_dir))

        out: Dict[str, float] = {}

        # paired waveform / mel metrics
        if same_name:
            # on full, uncropped files without the 2-s pad: the reference's
            # MelPairedDataset never applies target_length (load_mel.py:73-99;
            # only the Cnn14 / VGGish WaveDataset crops)
            t0 = clock()
            wav_gen = [load_wav_16k(p, None, pad_to_2s=False) for p in gen_paths]
            wav_ref = [load_wav_16k(p, None, pad_to_2s=False) for p in ref_paths]
            seconds["wav_load"] = clock() - t0
            t0 = clock()
            lsd = [M.log_spectral_distance(g, r, self.sampling_rate)
                   for g, r in zip(wav_gen, wav_ref)]
            seconds["lsd"] = clock() - t0

            t0 = clock()
            mel_gen = [stored_mels.get(os.path.basename(p)) for p in gen_paths]
            missing = [i for i, m in enumerate(mel_gen) if m is None]
            for i, m in zip(missing, batched_logmels([wav_gen[i] for i in missing],
                                                     self.eval_frontend)):
                mel_gen[i] = m
            mel_ref = batched_logmels(wav_ref, self.eval_frontend)
            seconds["mels"] = clock() - t0

            t0 = clock()
            psnr_vals, ssim_vals = [], []
            for mg, mr in zip(mel_gen, mel_ref):
                n = min(len(mg), len(mr))
                p = M.psnr(mg[:n], mr[:n])
                if np.isfinite(p):
                    psnr_vals.append(p)
                ssim_vals.append(M.ssim(mg[:n], mr[:n], data_range=1.0))
            out["lsd"] = float(np.mean([r["lsd"] for r in lsd]))
            out["ssim_stft"] = float(np.mean([r["ssim_stft"] for r in lsd]))
            out["psnr"] = float(np.mean(psnr_vals)) if psnr_vals else float("nan")
            out["ssim"] = float(np.mean(ssim_vals))
            seconds["psnr_ssim"] = clock() - t0
        else:
            out.update({"lsd": -1, "ssim_stft": -1, "psnr": -1, "ssim": -1})

        # Cnn14-based distribution metrics
        t0 = clock()
        gen_feats = self.cnn14_features(gen_paths)
        ref_feats = self.cnn14_features(ref_paths)
        seconds["cnn14"] = clock() - t0
        if gen_feats is not None and ref_feats is not None:
            gen_emb, gen_logits = gen_feats
            ref_emb, ref_logits = ref_feats
            t0 = clock()
            out["frechet_distance"] = M.frechet_distance(gen_emb, ref_emb)
            seconds["frechet_distance"] = clock() - t0
            t0 = clock()
            if same_name:
                out.update(M.kl_divergence_paired(gen_logits, ref_logits))
            out.update(M.inception_score(gen_logits))
            out.update(M.kernel_inception_distance(
                gen_emb, ref_emb, subsets=self.kid_subsets, subset_size=len(gen_paths)))
            seconds["kl_isc_kid"] = clock() - t0
        else:
            print("WARNING: Cnn14 checkpoint unavailable; FD/KL/ISc/KID skipped")

        # FAD (VGGish)
        from consistencytta_torch.evaluation.vggish import vggish_embeddings

        t0 = clock()
        vgg_gen = vggish_embeddings(gen_paths, self.vggish_checkpoint, device=self.device)
        vgg_ref = vggish_embeddings(ref_paths, self.vggish_checkpoint, device=self.device)
        seconds["vggish"] = clock() - t0
        if vgg_gen is not None and vgg_ref is not None:
            t0 = clock()
            out["frechet_audio_distance"] = M.frechet_distance(vgg_gen, vgg_ref)
            seconds["frechet_audio_distance"] = clock() - t0
        else:
            print("WARNING: VGGish checkpoint unavailable; FAD skipped")

        # CLAP scores
        if captions is not None:
            from consistencytta_torch.evaluation.clap import clap_embeddings

            t0 = clock()
            emb = clap_embeddings(
                gen_paths, ref_paths,
                [captions.get(os.path.basename(p), "") for p in gen_paths],
                self.clap_checkpoint, self.device,
            )
            seconds["clap"] = clock() - t0
            if emb is not None:
                out.update(M.clap_scores(emb["gt"], emb["gen"], emb["text"]))
            else:
                print("WARNING: CLAP checkpoint unavailable; CLAP scores skipped")

        result = {k: round(out.get(k, float("nan")), 4) for k in RESULT_KEYS}
        with open(generated_dir.rstrip("/") + "_evaluation_results.json", "w") as f:
            json.dump(result, f, indent=2)
        return result
