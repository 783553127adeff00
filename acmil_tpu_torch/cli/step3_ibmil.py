"""Step3 — IBMIL training, the port of ``Step3_WSI_classification_IBMIL.py``.

The two-phase protocol: phase 1 trains the plain attention model (no
``--c_path``); ``cli/ibmil_clustering.py`` then builds the confounder
dictionary from phase 1's best checkpoint; phase 2 trains again with
``--c_path`` naming the saved prototypes::

    python -m acmil_tpu_torch.cli.step3_ibmil \\
        --config config/camelyon_medical_ssl_config.yml --device cuda
    python -m acmil_tpu_torch.cli.ibmil_clustering \\
        --config config/camelyon_medical_ssl_config.yml --device cuda
    python -m acmil_tpu_torch.cli.step3_ibmil \\
        --config config/camelyon_medical_ssl_config.yml --ckpt_dir ckpt_p2 \\
        --c_path datasets_deconf/camelyon/train_bag_cls_agnostic_feats_proto_8_pretrain_medical_ssl_seed_4.npy \\
        --device cuda

The arch is always ``ibmil``. ``--c_learn`` trains the dictionary;
``--confounder_merge`` (cat, add or sub) merges the confounder feature into
the bag feature. As in the JAX script, both flags always carry a value
(``--c_learn`` false unless given, ``--confounder_merge`` cat), which wins
over the YAML. The head trains through its plain forward with autograd, as
in the JAX package.
"""

from __future__ import annotations

from acmil_tpu_torch.cli.train import base_parser, load_conf, run_training


def main(argv=None) -> dict:
    p = base_parser("IBMIL WSI classification (PyTorch)")
    p.add_argument("--c_path", nargs="+", default=None,
                   help="confounder prototype .npy path(s) (phase 2)")
    p.add_argument("--c_learn", action="store_true",
                   help="make the confounder dictionary trainable")
    p.add_argument("--confounder_merge", default="cat",
                   choices=["cat", "add", "sub"])
    args = p.parse_args(argv)
    conf = load_conf(args)
    conf.arch = "ibmil"
    return run_training(conf)


if __name__ == "__main__":
    main()
