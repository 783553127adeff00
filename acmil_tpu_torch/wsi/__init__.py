from acmil_tpu_torch.wsi.slide import (ImageSlide, Slide, clear_slide_cache,
                                      open_slide)

__all__ = ["ImageSlide", "Slide", "clear_slide_cache", "open_slide"]
