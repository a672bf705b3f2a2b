from repro_torch.models.model import DecoderModel, EncDecModel, build_model

__all__ = ["DecoderModel", "EncDecModel", "build_model"]
