"""Audio ingestion and the log-mel frontend."""

from .mel import (FeatureConfig, extract_features, log_mel_spectrogram,
                  mel_filter_bank, pad_or_trim)

__all__ = ["FeatureConfig", "extract_features", "log_mel_spectrogram",
           "mel_filter_bank", "pad_or_trim"]
