from care_tpu_torch.decoding.beam_search import beam_search
from care_tpu_torch.decoding.translator import (TranslatorARFormer,
                                                get_translator)

__all__ = ["beam_search", "TranslatorARFormer", "get_translator"]
