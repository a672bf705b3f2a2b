from repro_torch.models.model import DecoderModel

__all__ = ["DecoderModel"]
