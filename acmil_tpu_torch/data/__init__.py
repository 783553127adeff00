from acmil_tpu_torch.data.bags import (Bag, bucket_length, bucket_plan,
                                       collate_bags, pad_bag)
from acmil_tpu_torch.data.h5io import (FeatureBagSource,
                                       build_hdf5_feat_dataset,
                                       write_feature_h5)
from acmil_tpu_torch.data.loader import BagLoader
from acmil_tpu_torch.data.ptio import (PtBagSource, open_feature_source,
                                       write_feature_pt)

__all__ = [
    "Bag",
    "bucket_length",
    "bucket_plan",
    "collate_bags",
    "pad_bag",
    "FeatureBagSource",
    "build_hdf5_feat_dataset",
    "write_feature_h5",
    "BagLoader",
    "PtBagSource",
    "open_feature_source",
    "write_feature_pt",
]
