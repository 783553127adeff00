"""Step3 — MHIM training (masked hard instance mining with an EMA teacher),
the port of ``Step3_WSI_classification_MHIM.py``.

The two-stage protocol: ``--model pure`` pre-trains the teacher's network,
then ``--model mhim`` trains the student with that run's best checkpoint as
the teacher (``--teacher_init``), the student's input projection copied from
it (``--init_stu_type fc``)::

    python -m acmil_tpu_torch.cli.step3_mhim \\
        --config config/camelyon_medical_ssl_config.yml --model pure \\
        --ckpt_dir ckpt_pure --device cuda
    python -m acmil_tpu_torch.cli.step3_mhim \\
        --config config/camelyon_medical_ssl_config.yml --model mhim \\
        --teacher_init ckpt_pure --init_stu_type fc --mask_ratio_h 0.1 \\
        --mask_ratio_hr 0.5 --mm_sche --mrh_sche --ckpt_dir ckpt_mhim \\
        --device cuda

The arch is ``--model``. ``--baseline`` selfattn (two Nystrom layers with
PPEG) or attn (attention pooling). Every flag of this script carries a value
(its default when not given), which wins over the YAML, as in the JAX
script. ``--init_stu_type`` also takes ``fc``, which the JAX script's choices
leave out although its trainer and the reference support it. Both stages
train through the script's coupled-L2 Adam with no gradient clipping; the
heads train through plain forwards with autograd, as in the JAX package.
"""

from __future__ import annotations

from acmil_tpu_torch.cli.train import base_parser, load_conf, run_training


def main(argv=None) -> dict:
    p = base_parser("MHIM WSI classification (PyTorch)")
    p.add_argument("--model", default="mhim", choices=["mhim", "pure"])
    p.add_argument("--baseline", default="selfattn",
                   choices=["selfattn", "attn"])
    p.add_argument("--mask_ratio", type=float, default=0.0)
    p.add_argument("--mask_ratio_l", type=float, default=0.0)
    p.add_argument("--mask_ratio_h", type=float, default=0.0)
    p.add_argument("--mask_ratio_hr", type=float, default=1.0)
    p.add_argument("--cls_alpha", type=float, default=1.0)
    p.add_argument("--cl_alpha", type=float, default=0.1)
    p.add_argument("--mm", type=float, default=0.9999, help="EMA decay")
    p.add_argument("--mm_sche", action="store_true",
                   help="cosine schedule of the EMA decay")
    p.add_argument("--mrh_sche", action="store_true",
                   help="cosine decay of the high-attention mask ratio")
    p.add_argument("--mlp_dim", type=int, default=512)
    p.add_argument("--teacher_init", type=str, default="",
                   help="checkpoint dir (or file) of a 'pure' run for the "
                        "teacher")
    p.add_argument("--init_stu_type", default="none",
                   choices=["none", "fc", "all"],
                   help="also initialise the student from teacher_init: its "
                        "input projection (fc) or every weight (all)")
    args = p.parse_args(argv)
    conf = load_conf(args)
    conf.arch = args.model
    return run_training(conf)


if __name__ == "__main__":
    main()
