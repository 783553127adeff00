from acmil_tpu_torch.wsi.slide import ImageSlide, Slide, open_slide

__all__ = ["ImageSlide", "Slide", "open_slide"]
