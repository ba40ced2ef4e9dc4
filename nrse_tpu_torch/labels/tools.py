"""Label tooling CLI, the port's copy of ``nrse_tpu/labels/tools.py:35-76``
(the reference's ``labels/processed/*.py`` scripts).

Subcommands:
  process_txt   drop X/O lines from a semicolon list
                (``process_txt_label.py:14-60``)
  process_csv   drop X/O rows from a consensus CSV
                (``process_csv_label.py:15-58``)
  reformat      semicolon lists → baseline one-hot CSV with Split_Set lookup
                (``reformat_txt_baseline_gt.py:61-139``)
  prune         remove entries whose audio failed to load, scraped from
                training logs (``remove_problematic_files.py:116-146``)

Usage:
  python -m nrse_tpu_torch.labels.tools process_txt --input in.txt \
      --output out.txt
  python -m nrse_tpu_torch.labels.tools reformat --inputs a.txt b.txt \
      --consensus labels_consensus.csv --output onehot.csv
"""

from __future__ import annotations

import argparse

from nrse_tpu_torch.labels.parsing import (
    filter_consensus_csv,
    filter_label_list,
    reformat_lists_to_onehot_csv,
)
from nrse_tpu_torch.utils.preprocess_audio_files import (
    prune_label_list,
    scrape_problematic_files_from_logs,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description="MSP-Podcast label tooling")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("process_txt")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)

    p = sub.add_parser("process_csv")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)

    p = sub.add_parser("reformat")
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--consensus", default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--preserve_path", action="store_true")

    p = sub.add_parser("prune")
    p.add_argument("--list", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--logs", nargs="+", required=True)

    args = parser.parse_args(argv)
    if args.cmd == "process_txt":
        kept = filter_label_list(args.input, args.output)
        print(f"kept {kept} lines -> {args.output}")
    elif args.cmd == "process_csv":
        kept = filter_consensus_csv(args.input, args.output)
        print(f"kept {kept} rows -> {args.output}")
    elif args.cmd == "reformat":
        n = reformat_lists_to_onehot_csv(args.inputs, args.consensus,
                                         args.output, args.preserve_path)
        print(f"wrote {n} rows -> {args.output}")
    elif args.cmd == "prune":
        bad = scrape_problematic_files_from_logs(args.logs)
        kept = prune_label_list(args.list, args.output, bad)
        print(f"found {len(bad)} problematic files; kept {kept} lines")


if __name__ == "__main__":
    main()
