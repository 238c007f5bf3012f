from demovlp_tpu_torch.models.distilbert import DistilBertConfig, DistilBertModel
from demovlp_tpu_torch.models.dual_encoder import (ObjectMCRelation, ObjectQARelation,
                                                   ObjectRelation)
from demovlp_tpu_torch.models.object_transformer import ObjectTransformer

__all__ = ["DistilBertConfig", "DistilBertModel", "ObjectMCRelation", "ObjectQARelation",
           "ObjectRelation", "ObjectTransformer"]
