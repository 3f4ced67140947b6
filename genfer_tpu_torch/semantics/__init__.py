from .supportset import SupportSet, VarSupport
from .support_transform import SupportTransformer
from .gf_transformer import GfTransformer, GfTranslation

__all__ = [
    "SupportSet",
    "VarSupport",
    "SupportTransformer",
    "GfTransformer",
    "GfTranslation",
]
