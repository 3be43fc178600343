// Audio runtime: Opus encode/decode + optional PulseAudio capture/playback.
//
// The pcmflux-equivalent of this framework (reference consumes pcmflux's
// AudioCaptureSettings/AudioCapture/AudioChunkCallback, selkies.py:1005-1026;
// the legacy pipeline is pulsesrc→opusenc, gstwebrtc_app.py:1004-1121).
// Audio stays on the CPU: it is not a card target (SURVEY.md §7).
//
// All external deps are dlopen'd with locally-declared prototypes for the
// stable public APIs, so the lib builds with no dev headers installed and
// degrades gracefully: sa_opus_available()/sa_pulse_available() report what
// the host actually has.

#include <dlfcn.h>

#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// libopus (public API, opus.h)

typedef struct OpusEncoder OpusEncoder;
typedef struct OpusDecoder OpusDecoder;

constexpr int OPUS_APPLICATION_AUDIO = 2049;
constexpr int OPUS_APPLICATION_RESTRICTED_LOWDELAY = 2051;
constexpr int OPUS_SET_BITRATE = 4002;
constexpr int OPUS_SET_VBR = 4006;
constexpr int OPUS_SET_COMPLEXITY = 4010;
constexpr int OPUS_SET_INBAND_FEC = 4012;
constexpr int OPUS_SET_PACKET_LOSS_PERC = 4014;

struct OpusApi {
    OpusEncoder *(*encoder_create)(int32_t, int, int, int *);
    int32_t (*encode)(OpusEncoder *, const int16_t *, int, uint8_t *, int32_t);
    int (*encoder_ctl)(OpusEncoder *, int, ...);
    void (*encoder_destroy)(OpusEncoder *);
    OpusDecoder *(*decoder_create)(int32_t, int, int *);
    int (*decode)(OpusDecoder *, const uint8_t *, int32_t, int16_t *, int, int);
    void (*decoder_destroy)(OpusDecoder *);
    bool ok = false;
};

OpusApi *opus_api() {
    static OpusApi api;
    static bool tried = false;
    if (tried) return api.ok ? &api : nullptr;
    tried = true;
    void *h = dlopen("libopus.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libopus.so", RTLD_NOW | RTLD_GLOBAL);
    if (!h) return nullptr;
    api.encoder_create = (OpusEncoder * (*)(int32_t, int, int, int *))
        dlsym(h, "opus_encoder_create");
    api.encode = (int32_t(*)(OpusEncoder *, const int16_t *, int, uint8_t *,
                             int32_t))dlsym(h, "opus_encode");
    api.encoder_ctl = (int (*)(OpusEncoder *, int, ...))
        dlsym(h, "opus_encoder_ctl");
    api.encoder_destroy = (void (*)(OpusEncoder *))
        dlsym(h, "opus_encoder_destroy");
    api.decoder_create = (OpusDecoder * (*)(int32_t, int, int *))
        dlsym(h, "opus_decoder_create");
    api.decode = (int (*)(OpusDecoder *, const uint8_t *, int32_t, int16_t *,
                          int, int))dlsym(h, "opus_decode");
    api.decoder_destroy = (void (*)(OpusDecoder *))
        dlsym(h, "opus_decoder_destroy");
    api.ok = api.encoder_create && api.encode && api.encoder_ctl &&
             api.encoder_destroy && api.decoder_create && api.decode &&
             api.decoder_destroy;
    return api.ok ? &api : nullptr;
}

// ---------------------------------------------------------------------------
// libpulse-simple (public API, pulse/simple.h) — optional

typedef struct pa_simple pa_simple;

struct pa_sample_spec {
    int format;       // PA_SAMPLE_S16LE = 3
    uint32_t rate;
    uint8_t channels;
};

constexpr int PA_SAMPLE_S16LE = 3;
constexpr int PA_STREAM_PLAYBACK = 1;
constexpr int PA_STREAM_RECORD = 2;

struct PulseApi {
    pa_simple *(*simple_new)(const char *, const char *, int, const char *,
                             const char *, const pa_sample_spec *,
                             const void *, const void *, int *);
    int (*simple_read)(pa_simple *, void *, size_t, int *);
    int (*simple_write)(pa_simple *, const void *, size_t, int *);
    void (*simple_free)(pa_simple *);
    bool ok = false;
};

PulseApi *pulse_api() {
    static PulseApi api;
    static bool tried = false;
    if (tried) return api.ok ? &api : nullptr;
    tried = true;
    void *h = dlopen("libpulse-simple.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (!h) return nullptr;
    api.simple_new = (pa_simple * (*)(const char *, const char *, int,
                                      const char *, const char *,
                                      const pa_sample_spec *, const void *,
                                      const void *, int *))
        dlsym(h, "pa_simple_new");
    api.simple_read = (int (*)(pa_simple *, void *, size_t, int *))
        dlsym(h, "pa_simple_read");
    api.simple_write = (int (*)(pa_simple *, const void *, size_t, int *))
        dlsym(h, "pa_simple_write");
    api.simple_free = (void (*)(pa_simple *))dlsym(h, "pa_simple_free");
    api.ok = api.simple_new && api.simple_read && api.simple_write &&
             api.simple_free;
    return api.ok ? &api : nullptr;
}

}  // namespace

extern "C" {

int sa_opus_available() { return opus_api() != nullptr; }
int sa_pulse_available() { return pulse_api() != nullptr; }

// -- encoder ----------------------------------------------------------------

void *sa_enc_new(int rate, int channels, int bitrate, int vbr,
                 int complexity, int lowdelay, int inband_fec) {
    OpusApi *api = opus_api();
    if (!api) return nullptr;
    int err = 0;
    OpusEncoder *e = api->encoder_create(
        rate, channels,
        lowdelay ? OPUS_APPLICATION_RESTRICTED_LOWDELAY
                 : OPUS_APPLICATION_AUDIO,
        &err);
    if (!e || err != 0) return nullptr;
    api->encoder_ctl(e, OPUS_SET_BITRATE, bitrate);
    api->encoder_ctl(e, OPUS_SET_VBR, vbr ? 1 : 0);
    api->encoder_ctl(e, OPUS_SET_COMPLEXITY, complexity);
    if (inband_fec) {
        api->encoder_ctl(e, OPUS_SET_INBAND_FEC, 1);
        api->encoder_ctl(e, OPUS_SET_PACKET_LOSS_PERC, 5);
    }
    return e;
}

// pcm: interleaved s16, `frames` samples per channel (must be a valid Opus
// frame size for the rate, e.g. 960 for 20 ms @ 48 kHz).  Returns packet
// bytes written, or negative opus error.
int sa_enc_encode(void *h, const int16_t *pcm, int frames, uint8_t *out,
                  int32_t cap) {
    OpusApi *api = opus_api();
    if (!api || !h) return -1;
    return api->encode((OpusEncoder *)h, pcm, frames, out, cap);
}

void sa_enc_free(void *h) {
    OpusApi *api = opus_api();
    if (api && h) api->encoder_destroy((OpusEncoder *)h);
}

// -- decoder ----------------------------------------------------------------

void *sa_dec_new(int rate, int channels) {
    OpusApi *api = opus_api();
    if (!api) return nullptr;
    int err = 0;
    OpusDecoder *d = api->decoder_create(rate, channels, &err);
    return (err == 0) ? d : nullptr;
}

// Returns decoded samples per channel (≤ max_frames), or negative error.
int sa_dec_decode(void *h, const uint8_t *data, int32_t size, int16_t *out,
                  int max_frames) {
    OpusApi *api = opus_api();
    if (!api || !h) return -1;
    return api->decode((OpusDecoder *)h, data, size, out, max_frames, 0);
}

// In-band FEC recovery: reconstruct the LOST frame from the redundant
// data embedded in the FOLLOWING packet (fec=1). max_frames must equal
// the lost frame's duration (e.g. 960 for 20 ms @ 48 kHz).
int sa_dec_decode_fec(void *h, const uint8_t *data, int32_t size,
                      int16_t *out, int max_frames) {
    OpusApi *api = opus_api();
    if (!api || !h) return -1;
    return api->decode((OpusDecoder *)h, data, size, out, max_frames, 1);
}

// Packet-loss concealment: synthesize max_frames samples with no packet.
int sa_dec_plc(void *h, int16_t *out, int max_frames) {
    OpusApi *api = opus_api();
    if (!api || !h) return -1;
    return api->decode((OpusDecoder *)h, nullptr, 0, out, max_frames, 0);
}

void sa_dec_free(void *h) {
    OpusApi *api = opus_api();
    if (api && h) api->decoder_destroy((OpusDecoder *)h);
}

// -- PulseAudio capture / playback (optional on this host) -------------------

void *sa_pa_new(const char *device, int rate, int channels, int playback,
                const char *stream_name) {
    PulseApi *api = pulse_api();
    if (!api) return nullptr;
    pa_sample_spec ss;
    ss.format = PA_SAMPLE_S16LE;
    ss.rate = (uint32_t)rate;
    ss.channels = (uint8_t)channels;
    int err = 0;
    const char *dev = (device && device[0]) ? device : nullptr;
    return api->simple_new(nullptr, "selkies-tpu",
                           playback ? PA_STREAM_PLAYBACK : PA_STREAM_RECORD,
                           dev, stream_name ? stream_name : "stream", &ss,
                           nullptr, nullptr, &err);
}

int sa_pa_read(void *h, int16_t *out, int64_t bytes) {
    PulseApi *api = pulse_api();
    if (!api || !h) return -1;
    int err = 0;
    return api->simple_read((pa_simple *)h, out, (size_t)bytes, &err) == 0
               ? 0 : -err;
}

int sa_pa_write(void *h, const int16_t *pcm, int64_t bytes) {
    PulseApi *api = pulse_api();
    if (!api || !h) return -1;
    int err = 0;
    return api->simple_write((pa_simple *)h, pcm, (size_t)bytes, &err) == 0
               ? 0 : -err;
}

void sa_pa_free(void *h) {
    PulseApi *api = pulse_api();
    if (api && h) api->simple_free((pa_simple *)h);
}

}  // extern "C"
