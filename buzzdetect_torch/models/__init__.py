from buzzdetect_torch.models.registry import (  # noqa: F401
    BaseModel, BaseEmbedder, BundleModel, EmbedderYamnet,
    load_model, load_embedder)
from buzzdetect_torch.models.classifier import ChunkClassifier  # noqa: F401
