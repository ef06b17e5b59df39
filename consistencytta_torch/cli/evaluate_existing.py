"""Evaluate a directory of already generated wavs against references.

    python -m consistencytta_torch.cli.evaluate_existing --gen_dir GEN \
        --ref_dir REF --captions_json captions.json

The port's counterpart of cli/evaluate_existing.py (reference
evaluate_existing.py:42-59): the same flags, plus `--device` (default: the
card; "cpu" runs the backbones and the eval frontend's plain STFT there).
A backbone whose checkpoint file is absent gives NaN for its metrics.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate existing generations (PyTorch port)")
    p.add_argument("--gen_dir", type=str, required=True)
    p.add_argument("--ref_dir", type=str, required=True)
    p.add_argument("--captions_json", type=str, default=None,
                   help="json mapping wav filename -> caption (for CLAP)")
    p.add_argument("--cnn14_checkpoint", type=str, default="ckpt/Cnn14_16k_mAP=0.438.pth")
    p.add_argument("--vggish_checkpoint", type=str, default="ckpt/vggish.pth")
    p.add_argument("--clap_checkpoint", type=str,
                   default="ckpt/music_audioset_epoch_15_esc_90.14.pt")
    p.add_argument("--limit_num", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help='"cuda" (the card) or "cpu"')
    return p.parse_args(argv)


def evaluate(args):
    """(the metric dict, the seconds of each part) for parsed flags."""
    from consistencytta_torch.evaluation.harness import EvaluationHelper

    captions = None
    if args.captions_json:
        with open(args.captions_json) as f:
            captions = json.load(f)

    helper = EvaluationHelper(
        cnn14_checkpoint=args.cnn14_checkpoint,
        vggish_checkpoint=args.vggish_checkpoint,
        clap_checkpoint=args.clap_checkpoint,
        device=args.device,
    )
    result = helper.main(args.gen_dir, args.ref_dir, captions=captions, limit_num=args.limit_num)
    return result, helper.seconds


def main(argv=None) -> dict:
    """Run the evaluation; returns the metric dict it also prints."""
    result, _ = evaluate(parse_args(argv))
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
