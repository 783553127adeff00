from acmil_tpu_torch.models.encoders.build import (ENCODER_SPECS, CustomModel,
                                                  build_encoder)

__all__ = ["build_encoder", "CustomModel", "ENCODER_SPECS"]
