"""Base trainer CLI — the counterpart of the root `train_sr.py`.

Example (reference protocol, train_sr.py:357-392), on the card:

    python3 -m amid_tpu_torch.train_sr --overlap_ratio 0.25 -ds amazon \\
        -dm cloth_sport --model sasrec --seq_len 150 --neg_nums 199 \\
        --data_root <dir with the CSVs>

`--device cpu` runs on the CPU; the default is the card.
"""

import sys

from amid_tpu_torch.train.loop import cli_main


def main(argv=None):
    return cli_main(argv, is_dr=False)


if __name__ == "__main__":
    main(sys.argv[1:])
