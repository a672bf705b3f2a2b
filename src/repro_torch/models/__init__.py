from repro_torch.models.model import (DecoderModel, EncDecModel,
                                     HybridModel, XLSTMModel, build_model)

__all__ = ["DecoderModel", "EncDecModel", "HybridModel", "XLSTMModel",
           "build_model"]
