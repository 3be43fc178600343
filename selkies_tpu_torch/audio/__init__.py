"""Audio subsystem: Opus codec, capture sources, and the server pipeline.

The pcmflux-equivalent of this framework (reference: external pcmflux pip
package consumed at selkies.py:939-1090).  CPU-only by design.
"""

from .capture import (AudioCapture, AudioCaptureSettings, PcmSource,
                      PulseSource, SilenceSource, SyntheticTone, open_source)
from .codec import OpusDecoder, OpusEncoder, opus_available, pulse_available
from .pipeline import AudioPipeline, MicSink

__all__ = [
    "AudioCapture", "AudioCaptureSettings", "AudioPipeline", "MicSink",
    "OpusDecoder", "OpusEncoder", "PcmSource", "PulseSource",
    "SilenceSource", "SyntheticTone", "open_source", "opus_available",
    "pulse_available",
]
