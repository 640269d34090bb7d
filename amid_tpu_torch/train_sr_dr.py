"""Doubly-robust trainer CLI — the counterpart of the root `train_sr_dr.py`.

Canonical config (run.sh:1), on the card:

    python3 -m amid_tpu_torch.train_sr_dr --overlap_ratio 0.25 -ds mybank \\
        -dm loan_account --model sasrec --overlap True --isItC True --ts2 0.4 \\
        --neg_nums 999 --lr2 0.01 --dr_e_w 0.01 --data_root <dir with the CSVs>

`--comp_broadcast_quirk False` selects the pairwise mode, `--kernels cuda|torch`
the hand-written kernels or their plain versions, `--device cpu` the CPU (the
default is the card, and it is an error to have none).
"""

import sys

from amid_tpu_torch.train.loop import cli_main


def main(argv=None):
    return cli_main(argv, is_dr=True)


if __name__ == "__main__":
    main(sys.argv[1:])
