"""Step3 — ACMIL training, the port of ``Step3_WSI_classification_ACMIL.py``.

The same flags, YAMLs and defaults (seed 4 when none is given; an arch other
than ``ga`` or ``mha`` becomes ``ga``)::

    python -m acmil_tpu_torch.cli.step3_acmil \\
        --config config/camelyon_medical_ssl_config.yml \\
        --n_token 5 --n_masked_patch 10 --mask_drop 0.6 --device cuda

The ABMIL recipe is ``--n_token 1``. ``--arch ga`` trains ACMIL_GA
through kernels B1 and B2; ``--arch mha`` trains ACMIL_MHA through its
plain forward and autograd (its attention is plain products in the JAX
package too, outside any Pallas kernel).
"""

from __future__ import annotations

from acmil_tpu_torch.cli.train import base_parser, load_conf, run_training


def main(argv=None) -> dict:
    p = base_parser("ACMIL WSI classification (PyTorch)")
    p.add_argument("--n_token", type=int, default=None)
    p.add_argument("--n_masked_patch", type=int, default=None)
    p.add_argument("--mask_drop", type=float, default=None)
    args = p.parse_args(argv)
    conf = load_conf(args)
    if conf.arch not in ("ga", "mha"):
        conf.arch = "ga"
    if args.seed is None:
        conf.seed = 4  # reference default for ACMIL runs (README.md:51-58)
    return run_training(conf)


if __name__ == "__main__":
    main()
