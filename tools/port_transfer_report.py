"""BYOL→SER transfer evidence on the port: the reference's headline claim,
end to end on one card.

Counterpart of ``tools/transfer_report.py``.  The reference's claim is
that BYOL pretraining (a) lifts downstream SER macro-F1 and (b) flattens
the clean→snr4 degradation.  MSP-Podcast and AudioSet are not available,
so this runs the whole pipeline on the synthetic regime corpus
(``nrse_tpu_torch/data/synthetic.py``), WavLM-large at full width:

  1. BYOL pretraining, ``train_byol.main`` on the Train split's audio
     (clean against SNR-mixed views), the step from captured graphs;
  2. the SER trainers (``train_emotion.run``) once from the BYOL encoder
     (``emotion.encoder_checkpoint``) and once from seeded random weights:
     categorical with the encoder frozen (macro-F1), categorical
     fine-tuned end to end with noise in the training audio, and
     dimensional with the encoder frozen (CCC);
  3. ``evaluate_emotion.evaluate`` on the Development split of each leg's
     best checkpoint: clean, snr8 and snr4, the noise from a held-out
     noise corpus (seed 1) that no stage trained on;
  4. ``results.json`` and ``README.md`` under ``--out`` with the JAX
     report's keys and tables, and ``checks.json``: for each leg whether
     its encoder started as BYOL's online encoder (bit for bit, read from
     its phase-1 checkpoint, in which the encoder is frozen), whether its
     trainer's last step ran from graphs, the noise corpus its readout
     mixed in, its epoch records and the sha256 of its best checkpoint's
     state (``report_utils.checkpoint_digest``; BYOL's best too).

Usage (on the card; ``--smoke`` is a tiny CPU run of the same pipeline,
no quality claim):

    python3 tools/port_transfer_report.py [--train 4800] [--dev 960] \\
        [--byol-epochs 10] [--ser-epochs 8] [--ft-epochs 6] \\
        [--legs byol,random,byol_e2e,random_e2e] [--layers N] \\
        [--out docs/port_transfer_evidence] [--corpus build/port_transfer]

Every stage runs in this process, its state and graphs freed after it;
``--stage byol`` or ``--stage <task>:<variant>`` runs one stage (with
``--reuse``, what is cached on disk is taken, not rerun).  ``--ser-seed``
sets the SER legs' ``training.seed`` (the preset's 42 otherwise) and keys
their checkpoints and cached readouts by it, so that one BYOL checkpoint
serves legs of several seeds (``tools/port_transfer_seeds.py`` sums them
up).  A leg's
checkpoints are removed once its readout is cached (a checkpoint of the
24-layer classifier with its moments is 3.9 GB).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nrse_tpu_torch.utils import report_utils  # noqa: E402

# --smoke's clips: wavlm-tiny's frontend has stride 20, so 0.48 s is 383
# frames, the block attention's path (the CPU runs it fast)
SMOKE_CLIP_SECONDS = 0.48
TASKS = (("categorical", "dev_wavlm-large_emotion_cat.yaml", True),
         ("dimensional", "dev_wavlm-large_emotion_dim.yaml", False))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train", type=int, default=4800)
    p.add_argument("--dev", type=int, default=960)
    p.add_argument("--byol-epochs", type=int, default=10)
    p.add_argument("--byol-batch", type=int, default=36)
    p.add_argument("--ser-epochs", type=int, default=8)
    p.add_argument("--ser-batch", type=int, default=16)
    p.add_argument("--ser-lr", type=float, default=1e-3)
    p.add_argument("--ft-epochs", type=int, default=6,
                   help="phase-2 e2e fine-tune epochs (categorical)")
    p.add_argument("--ft-lr", type=float, default=2e-5)
    p.add_argument("--byol-snr", type=float, nargs="+",
                   default=[2.0, 4.0, 8.0, 12.0],
                   help="BYOL pretraining SNR choices (brackets eval 4/8)")
    p.add_argument("--noise-files", type=int, nargs=2, default=[600, 300],
                   metavar=("TRAIN", "EVAL"),
                   help="clips of the training and the held-out noise")
    p.add_argument("--skip-e2e", action="store_true")
    p.add_argument("--skip-dimensional", action="store_true")
    p.add_argument("--legs", default=None,
                   help="comma list of variants to run (byol,random,"
                        "byol_e2e,random_e2e); cached legs load regardless")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the encoder to this many layers (full width)")
    p.add_argument("--reuse", action="store_true",
                   help="reuse the BYOL checkpoint and cached readouts")
    p.add_argument("--out", default="docs/port_transfer_evidence")
    p.add_argument("--corpus", default=None,
                   help="where the corpora and checkpoints go (default "
                        "build/port_transfer, build/port_transfer_smoke)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny-encoder CPU pipeline check (no quality claim)")
    p.add_argument("--stage", default=None,
                   help="run one stage, 'byol' or '<task>:<variant>'")
    p.add_argument("--ser-seed", type=int, default=None,
                   help="the SER legs' training.seed (default: the "
                        "preset's)")
    args = p.parse_args(argv)
    if args.corpus is None:
        args.corpus = os.path.join(ROOT, "build", "port_transfer"
                                   + ("_smoke" if args.smoke else ""))
    if args.smoke:
        args.train, args.dev = 24, 8
        args.byol_epochs, args.ser_epochs = 1, 1
        args.ft_epochs = 1
        args.byol_batch = args.ser_batch = 4
        args.noise_files = [8, 4]
        if args.out == "docs/port_transfer_evidence":
            args.out = os.path.join(args.corpus, "out")
    return args


def _encoder(args):
    """The encoder BYOL pretrains when ``--layers`` cuts it, else None."""
    if args.layers is None or args.smoke:
        return None
    import dataclasses

    from nrse_tpu_torch.models.wavlm import WavLMConfig

    return dataclasses.replace(WavLMConfig.large(),
                               num_hidden_layers=args.layers)


def _stage_config(config, args):
    if args.smoke:
        config["data"]["max_audio_length"] = SMOKE_CLIP_SECONDS
    if args.layers is not None and not args.smoke:
        config["model"]["num_hidden_layers"] = args.layers
    return config


def main(argv=None) -> dict:
    """Runs the report; returns ``{"results": what results.json holds,
    "checks": what checks.json holds, "seconds": {stage: s}}``."""
    args = parse_args(argv)
    from nrse_tpu_torch.data.synthetic import (
        generate_corpus,
        generate_emotion_corpus,
    )

    t0 = time.perf_counter()
    seconds_of = {}
    seconds = 1.0 if args.smoke else 5.0
    audio_dir, labels_csv = generate_emotion_corpus(
        os.path.join(args.corpus, "emotion"), args.train, args.dev,
        seconds=seconds)
    # pretraining noise (seed 0) and HELD-OUT eval noise (seed 1)
    _, noise_train = generate_corpus(
        os.path.join(args.corpus, "noise_train"), 0, args.noise_files[0],
        seconds=seconds, seed=0)
    _, noise_eval = generate_corpus(
        os.path.join(args.corpus, "noise_eval"), 0, args.noise_files[1],
        seconds=seconds, seed=1)
    byol_clean = report_utils.symlink_split(
        audio_dir, os.path.join(args.corpus, "byol_clean"), "MSP-SYN_Tr_")
    log_dir = os.path.join(args.corpus, "logs")
    seconds_of["corpus"] = time.perf_counter() - t0

    # ---- stage 1: BYOL pretraining on the Train split ----
    byol_ckpt_dir = os.path.join(args.corpus, "byol_ckpt")
    byol_best = os.path.join(byol_ckpt_dir, "best_val_loss")
    checks = {}
    if args.stage in (None, "byol") and not (
            args.reuse and os.path.isdir(byol_best)):
        t = time.perf_counter()
        config = _stage_config(report_utils.byol_config(
            byol_clean, noise_train, byol_ckpt_dir, args.byol_epochs,
            args.byol_batch, log_dir, smoke=args.smoke,
            snr_range=args.byol_snr), args)
        info = report_utils.run_byol(config, _encoder(args))
        checks["byol"] = {"captured": info["captured"],
                          "steps": info["steps"],
                          "epochs": report_utils.records(info["epochs"]),
                          "s_per_step": [e["s_per_step"]
                                         for e in info["epochs"]],
                          "digest": report_utils.checkpoint_digest(
                              byol_best)}
        seconds_of["byol"] = time.perf_counter() - t
        print(f"# transfer: BYOL {json.dumps(checks['byol'])}", flush=True)
    if args.stage == "byol":
        return {"results": {}, "checks": checks, "seconds": seconds_of}
    if not os.path.isdir(byol_best):
        raise FileNotFoundError(f"no BYOL checkpoint at {byol_best}")
    print(f"# transfer: BYOL checkpoint at {byol_best}", flush=True)

    results = {}
    tasks = [t for t in TASKS
             if not (args.skip_dimensional and t[0] == "dimensional")]
    for task, preset, cat_only in tasks:
        variants = [("byol", byol_best, False), ("random", None, False)]
        if task == "categorical" and not args.skip_e2e:
            # the e2e phase-2 legs: the configuration the reference's flat
            # clean→snr4 row was measured with
            variants += [("byol_e2e", byol_best, True),
                         ("random_e2e", None, True)]
        for variant, enc, e2e in variants:
            stage = f"{task}:{variant}"
            key = f"{task}_{variant}"
            if args.stage is not None and args.stage != stage:
                continue
            run = key if args.ser_seed is None else \
                f"{key}_seed{args.ser_seed}"
            cache = os.path.join(args.corpus, f"readout_{run}.json")
            if args.reuse and os.path.exists(cache):
                with open(cache) as f:
                    cached = json.load(f)
                results[key], checks[key] = cached["readout"], cached["checks"]
                print(f"# transfer: readout {task}/{variant} (cached)",
                      flush=True)
                continue
            if args.legs is not None and variant not in args.legs.split(","):
                print(f"# transfer: skipping {task}/{variant} (--legs)",
                      flush=True)
                continue
            t = time.perf_counter()
            ckpt_dir = os.path.join(args.corpus, f"ser_{run}")
            config = _stage_config(report_utils.ser_config(
                preset, labels_csv, audio_dir, noise_train, enc, ckpt_dir,
                args.ser_epochs, args.ser_batch, args.ser_lr, cat_only,
                log_dir, smoke=args.smoke, e2e=e2e,
                ft_epochs=args.ft_epochs, ft_lr=args.ft_lr,
                snr_range=args.byol_snr), args)
            if args.ser_seed is not None:
                config["training"]["seed"] = args.ser_seed
            best = os.path.join(
                ckpt_dir,
                "best_fine_tuned_model" if e2e else "best_classifier_model")
            print(f"# transfer: training {task}/{variant}", flush=True)
            info = report_utils.train_ser(config, task)
            same = report_utils.same_encoder(
                os.path.join(ckpt_dir, "best_classifier_model"), byol_best,
                config)
            if same != (enc is not None):
                raise RuntimeError(
                    f"{task}/{variant}: the encoder it started from "
                    f"{'equals' if same else 'differs from'} BYOL's online "
                    f"encoder ({byol_best})")
            print(f"# transfer: readout {task}/{variant}", flush=True)
            results[key] = report_utils.robustness_readout(
                config, best, task, noise_eval)
            checks[key] = {"encoder_is_byol": same,
                           "captured": info["captured"],
                           "steps": info["steps"],
                           "best": info["best"],
                           "epochs": report_utils.records(info["epochs"]),
                           "digest": report_utils.checkpoint_digest(best),
                           "train_noise": config["data"]["noise_data_path"]
                           if e2e else None,
                           "readout_noise": noise_eval}
            with open(cache, "w") as f:
                json.dump({"readout": results[key], "checks": checks[key]},
                          f)
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            seconds_of[key] = time.perf_counter() - t
            print(json.dumps({key: results[key]}), flush=True)
    if args.stage is not None:
        return {"results": results, "checks": checks, "seconds": seconds_of}

    seconds_of["total"] = time.perf_counter() - t0
    write_artifact(args, results, checks, seconds_of)
    return {"results": results, "checks": checks, "seconds": seconds_of}


def write_artifact(args, results: dict, checks: dict,
                   seconds_of: dict) -> None:
    """``results.json``, ``checks.json`` and ``README.md`` under
    ``args.out``."""
    card = report_utils.card_line()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    with open(os.path.join(args.out, "checks.json"), "w") as f:
        json.dump({"card": card, "seconds": seconds_of, "legs": checks}, f,
                  indent=2)
    with open(os.path.join(args.out, "README.md"), "w") as f:
        f.write("\n".join(readme_lines(args, results, card, seconds_of))
                + "\n")
    print(json.dumps({"artifact": args.out}), flush=True)


def row(name, res, metric) -> str:
    c, s8, s4 = (res["clean"][metric], res["snr8"][metric],
                 res["snr4"][metric])
    return f"| {name} | {c:.3f} | {s8:.3f} | {s4:.3f} | {s4 - c:+.3f} |"


def readme_lines(args, results, card: str, seconds_of: dict) -> list:
    """The README's lines: the JAX report's tables
    (``tools/transfer_report.py:409-505``) under the port's header."""
    lines = [
        "# BYOL→SER transfer evidence on the port (synthetic regime corpus,"
        " one card)",
        "",
        f"Generated by `python3 tools/port_transfer_report.py --train "
        f"{args.train} --dev {args.dev} --byol-epochs {args.byol_epochs} "
        f"--ser-epochs {args.ser_epochs} --ft-epochs {args.ft_epochs}"
        + (f" --layers {args.layers}" if args.layers else "")
        + (f" --legs {args.legs}" if args.legs else "")
        + (" --skip-dimensional" if args.skip_dimensional else "")
        + ("" if args.ser_seed is None else f" --ser-seed {args.ser_seed}")
        + ("" if args.noise_files == [600, 300] or args.smoke else
           f" --noise-files {args.noise_files[0]} {args.noise_files[1]}")
        + ("`" if not args.smoke else " --smoke`") + f" on {card}, "
        f"{seconds_of.get('total', 0.0):.0f} s.",
        "",
        "The reference's headline result (dev.ipynb cell 52) is that BYOL",
        "pretraining lifts SER macro-F1 and flattens the clean→snr4",
        "degradation.  MSP-Podcast/AudioSet are not available, so this runs",
        "the same pipeline on the 8-regime synthetic emotion corpus:",
        "`train_byol.main` (WavLM-large, clean-vs-noisy BYOL views) on the",
        "Train split → the SER trainers (`train_emotion.run`) → "
        "`evaluate_emotion`",
        "readout on clean / snr8 / snr4 Development audio, with eval noise",
        "from a held-out seed.  The control is the same pipeline from a",
        "random-init encoder.  `checks.json` holds, for each leg, whether",
        "its encoder started as BYOL's online encoder bit for bit, whether",
        "its trainer ran from captured graphs, and the noise it read.",
        "",
    ]
    if "categorical_byol" in results and "categorical_random" in results:
        lines += [
            "## Categorical SER (macro-F1)",
            "",
            "| encoder (frozen) | clean | snr8 | snr4 | Δ(clean→snr4) |",
            "|---|---|---|---|---|",
            row("BYOL-pretrained", results["categorical_byol"], "macro_f1"),
            row("random-init", results["categorical_random"], "macro_f1"),
            "",
            "| encoder (frozen) | accuracy clean | snr8 | snr4 | Δ |",
            "|---|---|---|---|---|",
            row("BYOL-pretrained", results["categorical_byol"], "accuracy"),
            row("random-init", results["categorical_random"], "accuracy"),
        ]
    e2e_rows = [(name, results[key]) for name, key in
                (("BYOL-pretrained", "categorical_byol_e2e"),
                 ("random-init", "categorical_random_e2e"))
                if key in results]
    if e2e_rows:
        lines += [
            "",
            "## Categorical SER — e2e fine-tuned (the reference's flat-row"
            " config)",
            "",
            "Phase 2: the ENTIRE ssl model + heads trainable from epoch 0"
            " — transformer layers and conv frontend, matching"
            " run_train_e2e.sh --freeze_ssl=False, which gives every ssl"
            " parameter an optimizer"
            " (train_ft_cat_ser_weighted_checkpoint.py:209-214) —"
            " train-time noise augmentation on (config_cat_noisy.json"
            " points the reference's SER training at the noisy corpus),"
            " BYOL pretraining SNRs bracketing the eval points.  This is"
            " the configuration the reference's headline flat clean→snr4"
            " row was measured with (dev.ipynb cell 52).",
            "",
            "| encoder (e2e fine-tuned) | clean | snr8 | snr4 |"
            " Δ(clean→snr4) |",
            "|---|---|---|---|---|",
            *[row(name, res, "macro_f1") for name, res in e2e_rows],
            "",
            "| encoder (e2e fine-tuned) | accuracy clean | snr8 | snr4 |"
            " Δ |",
            "|---|---|---|---|---|",
            *[row(name, res, "accuracy") for name, res in e2e_rows],
        ]
    dim_rows = [(name, results[key]) for name, key in
                (("BYOL-pretrained", "dimensional_byol"),
                 ("random-init", "dimensional_random"))
                if key in results]
    if dim_rows:
        lines += ["", "## Dimensional SER (CCC)", ""]
        for dim in ("arousal", "valence", "dominance"):
            lines += [
                f"| encoder (frozen) | CCC {dim} clean | snr8 | snr4 | Δ |",
                "|---|---|---|---|---|",
                *[row(name, res, f"ccc_{dim}") for name, res in dim_rows],
                "",
            ]
    lines += [
        "",
        "Reference numbers being mirrored (real MSP-Podcast, dev.ipynb cell",
        "52): WavLM+BYOL e2e macro-F1 0.260/0.253/0.249 (clean/snr8/snr4)",
        "vs no-BYOL 0.233/0.235/0.223 — the claim is the *delta pattern*,",
        "which the table above measures on the synthetic corpus.",
    ]
    return lines


if __name__ == "__main__":
    main()
