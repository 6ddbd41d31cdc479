from .bpe import ByteLevelBPE, bytes_to_unicode
from .languages import LANGUAGES, LANGUAGE_CODES, TO_LANGUAGE_CODE
from .stitcher import decode_asr, find_longest_common_sequence
from .whisper_tokenizer import WhisperTokenizer
from .words import (collate_word_timestamps, combine_tokens_into_words,
                    merge_punctuations, split_tokens_on_spaces,
                    split_tokens_on_unicode)

__all__ = ["ByteLevelBPE", "bytes_to_unicode", "LANGUAGES",
           "LANGUAGE_CODES", "TO_LANGUAGE_CODE", "decode_asr",
           "find_longest_common_sequence", "WhisperTokenizer",
           "collate_word_timestamps", "combine_tokens_into_words",
           "merge_punctuations", "split_tokens_on_spaces",
           "split_tokens_on_unicode"]
