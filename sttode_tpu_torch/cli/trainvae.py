"""VAE-only training CLI of the port (port of ``sttode_tpu/cli/trainvae.py``).

    python -m sttode_tpu_torch.cli.trainvae --dataset nba --data_root D --ckpt_dir C

``cli.train`` with ``--loss_terms pred,recover,kl`` appended unless the
command line gives ``--loss_terms``: the ELBO terms only, no best-of-K
diverse objective, so no K-sample decode runs in the step. Every other flag
is ``cli.train``'s.
"""

from __future__ import annotations

import sys

from sttode_tpu_torch.cli.train import main as _train_main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--loss_terms") for a in argv):
        argv += ["--loss_terms", "pred,recover,kl"]
    return _train_main(argv)


if __name__ == "__main__":
    main()
