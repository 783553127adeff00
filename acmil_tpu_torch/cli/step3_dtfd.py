"""Step3 — DTFD-MIL training, the port of
``Step3_WSI_classification_DTFD.py``.

The same flags and defaults (``--numGroup`` 4, ``--total_instance`` 4,
``--distill`` MaxMinS|MaxS|AFS, ``--grad_clipping`` 5.0, each clipping one
of the four modules by its own norm)::

    python -m acmil_tpu_torch.cli.step3_dtfd \\
        --config config/camelyon_medical_ssl_config.yml --device cuda

The reference's two optimizers and ``retain_graph`` backward are one step
with a detached tier 2 (``models/dtfd.py``). Each pseudo-bag pools through
kernels B1 and B2 when ``models/fast.py::DTFD_FUSE_MIN_S`` routes it, else
through the plain forward. ``cli/step3_generic.py --arch dtfd`` trains the
same model with the YAML's keys.
"""

from __future__ import annotations

from acmil_tpu_torch.cli.train import base_parser, load_conf, run_training


def main(argv=None) -> dict:
    p = base_parser("DTFD-MIL WSI classification (PyTorch)")
    p.add_argument("--numGroup", type=int, default=4)
    p.add_argument("--total_instance", type=int, default=4)
    p.add_argument("--distill", type=str, default="MaxMinS",
                   choices=["MaxMinS", "MaxS", "AFS"])
    p.add_argument("--grad_clipping", type=float, default=5.0)
    conf = load_conf(p.parse_args(argv))
    conf.arch = "dtfd"
    return run_training(conf)


if __name__ == "__main__":
    main()
