"""Step3 — the generic MIL trainer, the port of
``Step3_WSI_classification.py``.

The same flags, YAMLs and arch names; the per-arch loss wiring lives in the
family registry. Of the JAX trainer's zoo the port registers ``abmil``,
``ga``, ``mha_single`` (the reference script's ``mha``, MHA), ``dsmil``,
``clam_sb``, ``clam_mb``, ``meanmil``, ``maxmil``, ``lbmil``, ``attmil``,
``attmil_gated``, ``ilra``, ``ips`` (``ips_m``/``ips_chunk`` from the
YAML), ``ibmil`` (its two-phase protocol has its own entry points,
``cli/step3_ibmil.py`` and ``cli/ibmil_clustering.py``), ``bmil_vis``,
``bmil_enc`` and ``bmil_spvis`` (the BMIL family: CE plus the ARD and data
KLs; ``bmil_grid`` from the YAML), ``transmil`` (``transmil_pad_mode``,
``compute_dtype`` from the YAML), ``mhim`` and ``pure`` (their keys from
the YAML; ``cli/step3_mhim.py`` is their own entry point), and ``dtfd``
(``numGroup``, ``total_instance``, ``distill`` and ``grad_clipping`` from the
YAML; ``cli/step3_dtfd.py`` is its own entry point)::

    python -m acmil_tpu_torch.cli.step3_generic \\
        --config config/camelyon_medical_ssl_config.yml --arch clam_mb \\
        --device cuda

DSMIL trains through its plain forward with autograd; every val/test bag
whose padded length reaches ``models/fast.py::FUSE_MIN_N`` is scored
through kernel B6. CLAM scores such bags through kernel B1, and trains them
through B1 and B2 when the YAML sets ``droprate: 0`` (with the CE instance
loss, ``inst_loss: ce``, the default); at the reference's dropout 0.25 it
trains through its plain forward. DTFD pools each pseudo-bag through B1
and B2 where ``models/fast.py::DTFD_FUSE_MIN_S`` routes it (never, at its
default). ``--w_loss`` mixes CLAM's bag and
instance losses (default 0.7). The rest of the zoo, TransMIL and MHIM
included, trains and scores through plain forwards with autograd, as in the
JAX package: none of those heads reaches a kernel there.
"""

from __future__ import annotations

from acmil_tpu_torch.cli.train import base_parser, load_conf, run_training


def main(argv=None) -> dict:
    p = base_parser("Generic WSI MIL classification (PyTorch)")
    p.add_argument("--w_loss", type=float, default=None,
                   help="bag/instance loss mix for CLAM (engine.py:103); "
                        "the attention-diversity weight for DSMIL")
    args = p.parse_args(argv)
    conf = load_conf(args)
    # the reference script's alias, so its command lines resolve as there
    if conf.arch == "mha":
        conf.arch = "mha_single"
    return run_training(conf)


if __name__ == "__main__":
    main()
