"""Step2 — patch feature extraction, the port of ``Step2_feature_extract.py``::

    python -m acmil_tpu_torch.cli.step2_extract --config config/camelyon_medical_ssl_config.yml \\
        --slide_dir SLIDES --coords_dir COORDS --output_dir OUT --device cuda

For every slide with Step1 coords it runs the patch encoder over batches of
patch pixels and writes one entry per slide: ``feat`` (float16 ``[N, D]``),
``coords`` and a ``label`` (from ``--label_csv``, else 0), the schema the
Step3 trainers read. ViT trunks run through ``encoders.fast.vit_encode``:
kernel B3 per layer for ViT-S/16, B4 for ViT-B/UNI/ViT-S/8, B5' for
CLIP-L/GigaPath. ResNet-18/50 trunks (``--backbone Resnet18|Resnet50``)
run their plain forward, cuDNN's convolutions in bf16.

``--roi_dir`` takes the ROI side path instead (`Step2:52-93`): an
ImageFolder-style directory of class subdirectories of crops, each crop
read with cv2, made RGB and resized to the encoder's size; the per-class
mean features, class 0 skipped, go to ``roi_feats.npy`` in
``--output_dir``.

Readers a machine may lack have torch-file adapters, each chosen by a flag:
``--coords_format pt`` reads ``<slide>.pt`` coords written by
``wsi/tiling.py::save_coords_pt`` instead of ``<slide>.h5``, and
``--out_format pt`` writes ``patch_feats_pretrain_{pretrain}.pt`` through
``data/ptio.py::write_feature_pt`` instead of the H5 (both need no
``h5py``).

Across processes, one per device as ``torchrun`` starts them, with the JAX
script's meaning and precedence (``Step2_feature_extract.py:186-201``)::

    torchrun --nproc_per_node 4 -m acmil_tpu_torch.cli.step2_extract \
        --mesh_data 2 --mesh_model 2 ...

``--mesh_model M > 1`` splits a ViT trunk's heads and MLP hidden units over
M ranks (``parallel/tp.py``) on a ``(max(mesh_data, 1), M)`` mesh;
otherwise ``--mesh_data N`` gives a data mesh of N ranks. On a data axis
each rank reads and encodes only every N-th row of every batch, and the
features are gathered back into coord order; under tensor parallelism the
first rank of each model group reads and broadcasts the images. Rank 0
alone writes the output. The backend is NCCL on the card and gloo on the
CPU, unless the YAML's ``dist_backend`` names one: ``gloo`` puts several
ranks on one card. ``--roi_dir`` runs on rank 0
alone, before any mesh is made.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import os
import time
from typing import List, Optional

import numpy as np
import torch

from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data.patch_dataset import SlidePatchBatches
from acmil_tpu_torch.models.encoders.build import (build_encoder,
                                                   encoder_feature_fn)
from acmil_tpu_torch.utils import profiling
from acmil_tpu_torch.utils.device import entry_device
from acmil_tpu_torch.wsi.slide import SLIDE_EXTS, open_slide
from acmil_tpu_torch.wsi.tiling import load_coords_h5, load_coords_pt


def extract_slide_features(embed, spec, slide, coords, patch_size_l0,
                           patch_level, batch_size=256, mesh=None,
                           device=None) -> np.ndarray:
    """fp16 features ``[len(coords), embed_dim]`` of one slide; ``embed`` is
    the closure of ``encoder_feature_fn`` (or, under tensor parallelism,
    ``parallel/tp.py::tp_encoder_feature_fn``), built once for all slides.
    On a ``mesh`` this rank reads its rows of each batch (on the model
    group's first rank only, which broadcasts them to the group) and every
    rank gets the whole slide's features. The spans ``step2.read`` (the
    reader's next batch) and ``step2.copy_back`` (the slide's features to
    host memory) name the host's parts around the encoder's."""
    shard = (0, 1) if mesh is None else (mesh.data_index, mesh.data)
    src = SlidePatchBatches(slide, coords, patch_size_l0, patch_level,
                            target_size=spec.img_size, batch_size=batch_size,
                            shard=shard)
    tp = mesh is not None and mesh.model_group is not None
    if tp:
        from acmil_tpu_torch.parallel.tp import broadcast_images

        block = (src.rows, spec.img_size, spec.img_size, 3)
    reads = not tp or mesh.model_index == 0
    batches = (item[0] for item in src) if reads else itertools.repeat(
        None, len(src))
    feats = []
    for g, imgs in enumerate(_read_spans(batches)):
        if tp:
            imgs = broadcast_images(imgs, mesh, block, device)
        n = min(batch_size, len(coords) - g * batch_size)
        feats.append(embed(imgs)[:n])                 # stays on the device
    if not feats:
        return np.zeros((0, spec.embed_dim), np.float16)
    with profiling.span("step2.copy_back"):
        out = torch.cat(feats).cpu().numpy()
    profiling.settle()
    return out


def _read_spans(batches):
    """``batches``, each one's read inside a ``step2.read`` span."""
    it = iter(batches)
    while True:
        with profiling.span("step2.read"):
            try:
                imgs = next(it)
            except StopIteration:
                return
        yield imgs


def extract_roi_features(embed, spec, roi_dir: str, output_dir: str,
                         batch_size: int = 64) -> np.ndarray:
    """Per-class mean features ``[n_classes - 1, embed_dim]`` (float32) of
    the crops under ``roi_dir``'s class subdirectories (sorted; class 0
    skipped, as the reference does), written to
    ``output_dir/roi_feats.npy``. ``embed`` is a float32 closure of
    ``encoder_feature_fn``; each batch is padded to ``batch_size`` with
    zeros, so every call has one shape."""
    import cv2

    classes = sorted(d for d in os.listdir(roi_dir)
                     if os.path.isdir(os.path.join(roi_dir, d)))
    size = spec.img_size
    feats, labels = [], []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(roi_dir, cls)
        files = sorted(f for f in os.listdir(cdir)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
        for i in range(0, len(files), batch_size):
            chunk = files[i:i + batch_size]
            imgs = np.zeros((batch_size, size, size, 3), np.uint8)
            for j, fname in enumerate(chunk):
                img = cv2.imread(os.path.join(cdir, fname))
                if img is None:
                    raise ValueError(f"cv2 cannot read {cdir}/{fname}")
                imgs[j] = cv2.resize(cv2.cvtColor(img, cv2.COLOR_BGR2RGB),
                                     (size, size))
            feats.append(embed(imgs)[:len(chunk)].float().cpu().numpy())
            labels.extend([ci] * len(chunk))
    feats, labels = np.concatenate(feats), np.asarray(labels)
    centroids = np.stack([feats[labels == c].mean(axis=0)
                          for c in range(1, len(classes))])
    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir, "roi_feats.npy")
    np.save(out, centroids)
    print(f"roi centroids {centroids.shape} -> {out}")
    return centroids


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("Step2: feature extraction (PyTorch)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--slide_dir", default=None)
    p.add_argument("--coords_dir", default=None,
                   help="Step1 save_dir/patches with per-slide coords")
    p.add_argument("--output_dir", required=True)
    # default=None so YAML values survive the merge (Config's own defaults
    # are ViT-S/16 / medical_ssl)
    p.add_argument("--backbone", default=None)
    p.add_argument("--pretrain", default=None)
    p.add_argument("--pretrain_weights", default="",
                   help="local torch checkpoint of the encoder")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--label_csv", default=None,
                   help="CSV with slide_id,label columns")
    p.add_argument("--coords_format", choices=["h5", "pt"], default="h5",
                   help="Step1 coords per slide: <slide>.h5, or <slide>.pt "
                        "from wsi/tiling.py::save_coords_pt")
    p.add_argument("--out_format", choices=["h5", "pt"], default="h5",
                   help="feature file: the reference's H5, or a torch file "
                        "(data/ptio.py)")
    p.add_argument("--roi_dir", default=None,
                   help="ImageFolder-style ROI crops: write per-class "
                        "centroid features instead of slide bags")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; without a card, raises "
                        "unless this is cpu)")
    p.add_argument("--mesh_data", type=int, default=None,
                   help="shard extraction batches over N processes (one "
                        "per device, under torchrun; 0 = one process)")
    p.add_argument("--mesh_model", type=int, default=None,
                   help="tensor-parallel degree of the trunk: attention "
                        "heads and MLP hidden units over N processes "
                        "(Megatron, ViT trunks only; composes with "
                        "--mesh_data as a (data, model) mesh)")
    return p.parse_args(argv)


def _read_labels(path: Optional[str]) -> dict:
    if not path:
        return {}
    with open(path, newline="") as f:
        return {row["slide_id"]: int(row["label"]) for row in csv.DictReader(f)}


def _find_slide(slide_dir: str, name: str) -> Optional[str]:
    for ext in SLIDE_EXTS:
        cand = os.path.join(slide_dir, name + ext)
        if os.path.exists(cand):
            return cand
    return None


def _encoder(conf):
    """The encoder and its spec; seeded random (seed 0) when no weights are
    given."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model, spec, _ = build_encoder(conf)
    return model, spec


class _H5Out:
    """Appends one group per slide to the reference's feature H5."""

    def __init__(self, path):
        import h5py

        self.f = h5py.File(path, "a")

    def __contains__(self, name):
        return name in self.f

    def add(self, name, feats, coords, label):
        g = self.f.create_group(name)
        g.create_dataset("feat", data=feats.astype(np.float16))
        g.create_dataset("coords", data=coords)
        g.attrs["label"] = int(label)

    def close(self):
        self.f.close()


class _PtOut:
    """Collects slides and writes the torch feature file on close, keeping
    the slides an earlier run wrote there."""

    def __init__(self, path):
        self.path = path
        self.slides = {}
        if os.path.exists(path):
            old = torch.load(path, map_location="cpu", weights_only=True)
            self.slides = {k: {"feat": v["feat"].numpy(),
                               "coords": v["coords"].numpy(),
                               "label": int(v["label"])}
                           for k, v in old.items()}

    def __contains__(self, name):
        return name in self.slides

    def add(self, name, feats, coords, label):
        self.slides[name] = {"feat": feats, "coords": coords, "label": label}

    def close(self):
        from acmil_tpu_torch.data.ptio import write_feature_pt

        write_feature_pt(self.path, self.slides)


def build_mesh(conf, device: torch.device):
    """The extraction mesh from ``mesh_model`` and ``mesh_data`` (the JAX
    script's precedence), or None when neither asks for one. Joins the
    process group ``torchrun`` describes first; ``make_mesh`` raises,
    naming the launch, unless the world has the mesh's size."""
    mesh_data = int(getattr(conf, "mesh_data", 0) or 0)
    mesh_model = int(getattr(conf, "mesh_model", 0) or 0)
    if mesh_model <= 1 and not mesh_data:
        return None
    from acmil_tpu_torch.parallel import init_distributed, make_mesh

    if device.type == "cuda":
        torch.cuda.set_device(device)       # NCCL's objects go to this card
    init_distributed(device, getattr(conf, "dist_backend", None))
    if mesh_model > 1:
        return make_mesh(max(mesh_data, 1), 1, device, model=mesh_model)
    return make_mesh(mesh_data, 1, device)


def _skipped_by_lead(names, out, mesh) -> set:
    """The slides the output already holds, as rank 0 (the writer) sees
    them, on every rank: every rank must walk the same slides, or the ranks
    reach different collectives."""
    held = {n for n in names if n in out} if out is not None else None
    if mesh is None or mesh.world == 1:
        return held
    import torch.distributed as dist

    box = [held]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def main(argv: Optional[List[str]] = None) -> dict:
    """Extracts every slide; returns ``{"out_path", "slides": {name:
    patches}, "slide_seconds": {name: seconds}, "patches", "seconds"}``
    (seconds of extraction, the slide's open and reads included). With
    ``--roi_dir``: ``{"out_path", "centroids"}`` (centroids None on a rank
    other than 0). On a mesh every rank returns the same slides; rank 0
    alone writes."""
    args = parse_args(argv)
    device = entry_device(args.device)
    overrides = {k: v for k, v in vars(args).items() if v is not None}
    conf = (Config.from_yaml(args.config, overrides) if args.config
            else Config.from_dict(overrides))
    conf.resolve_dims()
    batch_size = int(getattr(conf, "batch_size", 0) or 256)
    if args.roi_dir:
        # before any mesh, as the JAX script; one writer under torchrun
        out_path = os.path.join(args.output_dir, "roi_feats.npy")
        if int(os.environ.get("RANK", "0")) != 0:
            return {"out_path": out_path, "centroids": None}
        model, spec = _encoder(conf)
        embed = encoder_feature_fn(model, spec, device,
                                   out_dtype=torch.float32)
        centroids = extract_roi_features(embed, spec, args.roi_dir,
                                         args.output_dir, batch_size)
        return {"out_path": out_path, "centroids": centroids}
    if not args.slide_dir or not args.coords_dir:
        raise SystemExit("--slide_dir and --coords_dir are required "
                         "(or use --roi_dir)")
    labels = _read_labels(args.label_csv)
    suffix = "." + args.coords_format
    coord_files = sorted(f for f in os.listdir(args.coords_dir)
                         if f.endswith(suffix))
    if not coord_files:
        raise SystemExit(f"no coords {suffix} files in {args.coords_dir!r}: "
                         "Step1 writes them under <save_dir>/patches/")
    load_coords = load_coords_h5 if args.coords_format == "h5" else load_coords_pt

    if getattr(conf, "mesh_data", None) or getattr(conf, "mesh_model", None):
        from acmil_tpu_torch.parallel import local_device

        device = local_device(args.device)
    mesh = build_mesh(conf, device)
    model, spec = _encoder(conf)
    if mesh is not None and mesh.model > 1:
        from acmil_tpu_torch.parallel.tp import tp_encoder_feature_fn

        embed = tp_encoder_feature_fn(model, spec, mesh, device)
    else:
        embed = encoder_feature_fn(model, spec, device, mesh=mesh)

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"patch_feats_pretrain_"
                                             f"{conf.pretrain}.{args.out_format}")
    out = None
    if lead:
        out = _H5Out(out_path) if args.out_format == "h5" else _PtOut(out_path)
    done, secs = {}, {}
    try:
        held = _skipped_by_lead([os.path.splitext(cf)[0]
                                 for cf in coord_files], out, mesh)
        for cf in coord_files:
            name = os.path.splitext(cf)[0]
            if name in held:
                say(f"{name}: exists, skipping")
                continue
            slide_path = _find_slide(args.slide_dir, name)
            if slide_path is None:
                say(f"{name}: slide not found, skipping")
                continue
            coords, _, attrs = load_coords(os.path.join(args.coords_dir, cf))
            if len(coords) == 0:
                say(f"{name}: no patches, skipping")
                continue
            t0 = time.perf_counter()
            slide = open_slide(slide_path)
            patch_size_l0 = int(attrs.get("patch_size", 512) *
                                attrs.get("downsample", 1.0))
            feats = extract_slide_features(
                embed, spec, slide, coords, patch_size_l0,
                int(attrs.get("patch_level", 0)), batch_size, mesh, device)
            dt = time.perf_counter() - t0
            if out is not None:
                out.add(name, feats, coords, labels.get(name, 0))
            done[name], secs[name] = len(feats), dt
            say(f"{name}: {len(feats)} patches in {dt:.1f}s "
                f"({len(feats) / max(dt, 1e-9):.0f} patches/s)")
    finally:
        if out is not None:
            out.close()
    say(f"features -> {out_path}")
    return {"out_path": out_path, "slides": done, "slide_seconds": secs,
            "patches": sum(done.values()), "seconds": sum(secs.values())}


if __name__ == "__main__":
    main()
