from care_tpu_torch.decoding import nar
from care_tpu_torch.decoding.beam_search import beam_search
from care_tpu_torch.decoding.translator import (TranslatorARFormer,
                                                TranslatorNARFormer,
                                                get_translator)

__all__ = ["beam_search", "nar", "TranslatorARFormer", "TranslatorNARFormer",
           "get_translator"]
