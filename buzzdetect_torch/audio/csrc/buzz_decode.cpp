// buzz_decode: host-side audio decode/resample stage for buzzdetect_torch.
//
// The same source as buzzdetect_tpu/audio/csrc/buzz_decode.cpp: only this
// header comment differs. buzzdetect_torch/audio/ffi.py compiles it with g++
// at first use into buzzdetect_torch/csrc/build/ and loads it with ctypes.
//
// One C++ stage replaces the reference's entire native decode surface
// (PyAV/FFmpeg drivers in src/stream/drivers/, libsndfile via soundfile,
// librosa/soxr resampling — see SURVEY.md §2b): libavformat demux +
// libavcodec decode + libswresample downmix/resample to mono float32 at the
// model rate, fully outside the Python GIL, exposed through a minimal C ABI
// consumed via ctypes.
//
// Sample-accurate seek honors the per-codec findings documented by the
// reference drivers (behavioral knowledge, not code):
//   * MP4/AAC (reference src/stream/drivers/mp4.py): container pts is exact,
//     but the first decoded frame after a cold seek is corrupt (MDCT
//     overlap-add) -> seek early by a preroll and discard up to the target.
//   * WMA/ASF (drivers/wma.py): pts drifts thousands of samples -> pts can
//     NOT be trusted; bit-exact positioning requires counting decoded
//     samples from a known point. We reopen + count forward (the driver's
//     landmark cache is an optimization of the same invariant; forward
//     streaming, which dominates our access pattern, never hits this path).
//   * MTS/AC3 (drivers/mts.py): decoder never resyncs after container seek ->
//     fresh-open + forward decode is the only correct path.
// Strategy selection is by codec id; unknown codecs default to the safe
// reopen-and-count path.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>
#include <algorithm>

extern "C" {
#include <libavformat/avformat.h>
#include <libavcodec/avcodec.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {

enum SeekStrategy {
    SEEK_PTS = 0,     // container seek w/ preroll, trust pts (wav/flac/mp3/aac/vorbis/opus)
    SEEK_REOPEN = 1,  // reopen + decode-count forward (wma, ac3, unknown)
};

struct BzStream {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* dec = nullptr;
    SwrContext* swr = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    int stream_index = -1;

    std::string path;
    int out_rate = 0;          // output samplerate (mono f32)
    int native_rate = 0;
    int native_channels = 0;
    SeekStrategy strategy = SEEK_REOPEN;
    int preroll_native = 0;    // extra native samples to decode before target

    int64_t out_pos = 0;       // output samples delivered so far (logical pos)
    int64_t native_pos = 0;    // native samples fed into swr since open/seek
    int64_t duration_out = -1; // estimated duration in output samples

    bool draining = false;     // sent NULL packet to decoder
    bool eof_out = false;      // swr fully flushed
    std::vector<float> fifo;   // decoded+converted output samples
    size_t fifo_head = 0;

    // discard this many native samples before feeding swr (post-seek)
    int64_t native_discard = 0;
    // drop this many OUTPUT samples produced after a seek (swr warmup + phase)
    int64_t out_drop = 0;

    // the input format swr is currently configured for; push_frame compares
    // every decoded frame against this (corrupt streams — and legitimately,
    // broadcast codecs like AC3 — can switch layout/format/rate mid-stream;
    // converting a mismatched frame makes swr read channel planes that do
    // not exist)
    AVChannelLayout swr_in_layout {};
    int swr_in_fmt = -1;       // AVSampleFormat
    int swr_in_rate = 0;

    std::string error;
};

void set_err(BzStream* s, const char* what, int averr = 0) {
    char buf[256] = {0};
    if (averr) av_strerror(averr, buf, sizeof(buf));
    s->error = std::string(what) + (averr ? std::string(": ") + buf : "");
}

// (Re)build the mono-f32 resampler for the given input parameters and
// record them in the stream so per-frame validation can detect changes.
// ``src_layout`` may be UNSPEC (or null), in which case the default layout
// for ``in_channels`` is used — matching what the decoder actually emits.
int config_swr(BzStream* s, const AVChannelLayout* src_layout,
               AVSampleFormat in_fmt, int in_rate, int in_channels) {
    if (s->swr) swr_free(&s->swr);
    av_channel_layout_uninit(&s->swr_in_layout);
    s->swr_in_fmt = -1;
    s->swr_in_rate = 0;

    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    AVChannelLayout in_layout;
    if (!src_layout || src_layout->order == AV_CHANNEL_ORDER_UNSPEC)
        av_channel_layout_default(&in_layout, in_channels);
    else
        av_channel_layout_copy(&in_layout, src_layout);

    int ret = swr_alloc_set_opts2(&s->swr,
                                  &mono, AV_SAMPLE_FMT_FLT, s->out_rate,
                                  &in_layout, in_fmt, in_rate,
                                  0, nullptr);
    if (ret < 0) {
        if (s->swr) swr_free(&s->swr);  // never leave a half-built context
        av_channel_layout_uninit(&in_layout);
        set_err(s, "swr alloc", ret);
        return ret;
    }
    // equal-weight mean downmix (swresample defaults to 0.707 gains for
    // stereo->mono; the contract is np.mean over channels, as in the
    // reference streamer `src/stream/worker.py:117`)
    int nch = in_layout.nb_channels;
    if (nch > 1) {
        std::vector<double> matrix(nch, 1.0 / nch);
        swr_set_matrix(s->swr, matrix.data(), nch);
    }
    ret = swr_init(s->swr);
    if (ret < 0) {
        swr_free(&s->swr);  // an uninitialized context must not linger
        av_channel_layout_uninit(&in_layout);
        set_err(s, "swr init", ret);
        return ret;
    }
    av_channel_layout_copy(&s->swr_in_layout, &in_layout);
    av_channel_layout_uninit(&in_layout);
    s->swr_in_fmt = (int)in_fmt;
    s->swr_in_rate = in_rate;
    return 0;
}

SeekStrategy strategy_for(AVCodecID id) {
    switch (id) {
        case AV_CODEC_ID_PCM_S16LE: case AV_CODEC_ID_PCM_S24LE:
        case AV_CODEC_ID_PCM_S32LE: case AV_CODEC_ID_PCM_F32LE:
        case AV_CODEC_ID_PCM_F64LE: case AV_CODEC_ID_PCM_U8:
        case AV_CODEC_ID_PCM_S8:    case AV_CODEC_ID_PCM_S16BE:
        case AV_CODEC_ID_FLAC:
        case AV_CODEC_ID_MP3: case AV_CODEC_ID_MP2:
        case AV_CODEC_ID_AAC:
        case AV_CODEC_ID_OPUS:
            return SEEK_PTS;
        case AV_CODEC_ID_WMAV1: case AV_CODEC_ID_WMAV2:
        case AV_CODEC_ID_WMAPRO: case AV_CODEC_ID_WMALOSSLESS:
        case AV_CODEC_ID_AC3: case AV_CODEC_ID_EAC3:
        // Vorbis: Ogg granulepos marks packet END; the post-seek pts libav
        // derives lands samples off (measured ~0.46 amplitude error) —
        // count-forward is the only exact path
        case AV_CODEC_ID_VORBIS:
            return SEEK_REOPEN;
        default:
            return SEEK_REOPEN;
    }
}

int preroll_for(AVCodecID id, int rate) {
    switch (id) {
        case AV_CODEC_ID_AAC:  return 2 * 1024;  // 1 corrupt frame + margin
        case AV_CODEC_ID_MP3:  return 10 * 1152; // bit-reservoir spans frames
        case AV_CODEC_ID_MP2:  return 10 * 1152;
        case AV_CODEC_ID_VORBIS: case AV_CODEC_ID_OPUS: return 2 * 4096;
        case AV_CODEC_ID_FLAC: return 0;
        default: return rate / 10;               // 100 ms safety margin
    }
}

int open_internal(BzStream* s) {
    int ret = avformat_open_input(&s->fmt, s->path.c_str(), nullptr, nullptr);
    if (ret < 0) { set_err(s, "open_input", ret); return ret; }
    ret = avformat_find_stream_info(s->fmt, nullptr);
    if (ret < 0) { set_err(s, "find_stream_info", ret); return ret; }

    const AVCodec* codec = nullptr;
    ret = av_find_best_stream(s->fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (ret < 0) { set_err(s, "no audio stream", ret); return ret; }
    s->stream_index = ret;
    AVStream* st = s->fmt->streams[s->stream_index];

    s->dec = avcodec_alloc_context3(codec);
    if (!s->dec) { set_err(s, "alloc codec ctx"); return AVERROR(ENOMEM); }
    ret = avcodec_parameters_to_context(s->dec, st->codecpar);
    if (ret < 0) { set_err(s, "params_to_context", ret); return ret; }
    s->dec->pkt_timebase = st->time_base;
    ret = avcodec_open2(s->dec, codec, nullptr);
    if (ret < 0) { set_err(s, "codec open", ret); return ret; }

    s->native_rate = s->dec->sample_rate;
    s->native_channels = s->dec->ch_layout.nb_channels;
    if (s->out_rate <= 0) s->out_rate = s->native_rate;
    s->strategy = strategy_for(codec->id);
    s->preroll_native = preroll_for(codec->id, s->native_rate);
    // AAC pts is only sample-exact in mp4/mov containers, whose edit lists
    // account for the encoder's priming samples; in matroska/avi/etc the
    // pts is offset by the priming -> only count-forward is exact
    if (codec->id == AV_CODEC_ID_AAC && s->fmt->iformat
        && !strstr(s->fmt->iformat->name, "mp4")
        && !strstr(s->fmt->iformat->name, "mov"))
        s->strategy = SEEK_REOPEN;

    ret = config_swr(s, &s->dec->ch_layout, s->dec->sample_fmt,
                     s->native_rate, s->native_channels);
    if (ret < 0) return ret;

    // duration estimate (container metadata; may lie for truncated files —
    // short reads at EOF are the caller's bad-read signal, as in the
    // reference's handle_bad_read)
    int64_t dur_native = -1;
    if (st->duration > 0 && st->time_base.num > 0)
        dur_native = av_rescale_q(st->duration, st->time_base,
                                  AVRational{1, s->native_rate});
    else if (s->fmt->duration > 0)
        dur_native = av_rescale(s->fmt->duration, s->native_rate, AV_TIME_BASE);
    s->duration_out = dur_native >= 0
        ? av_rescale(dur_native, s->out_rate, s->native_rate) : -1;

    s->draining = false;
    s->eof_out = false;
    s->native_pos = 0;
    s->native_discard = 0;
    s->out_drop = 0;
    s->fifo.clear();
    s->fifo_head = 0;
    return 0;
}

void close_internal(BzStream* s) {
    if (s->swr) swr_free(&s->swr);
    av_channel_layout_uninit(&s->swr_in_layout);
    s->swr_in_fmt = -1;
    s->swr_in_rate = 0;
    if (s->dec) avcodec_free_context(&s->dec);
    if (s->fmt) avformat_close_input(&s->fmt);
}

// Drop pending post-seek warmup OUTPUT samples from the fifo head. Must run
// after every swr_convert that appends output — including the EOF tail
// flush: the resampler's delay line can still hold warmup input when the
// decoder hits EOF, so the flushed tail may carry warmup output that would
// otherwise be mislabeled as target-position audio.
void apply_out_drop(BzStream* s) {
    if (s->out_drop > 0) {
        size_t avail = s->fifo.size() - s->fifo_head;
        size_t drop = std::min<size_t>(avail, (size_t)s->out_drop);
        s->fifo_head += drop;
        s->out_drop -= drop;
    }
}

// Feed one decoded frame through discard/swr into the fifo.
int push_frame(BzStream* s, AVFrame* fr) {
    int in_n = fr->nb_samples;
    const uint8_t** in_data = (const uint8_t**)fr->extended_data;

    // Validate the frame before trusting its layout. Corrupt streams (and
    // legitimately, broadcast codecs like AC3 in MTS captures) can emit
    // frames whose channel layout, sample format, or rate differ from the
    // open-time stream parameters; swr configured for the old layout would
    // read channel plane pointers that do not exist (found by
    // tools/fuzz_decode.py: SIGSEGV inside swr_convert on a bit-flipped
    // AC3 stream that switched 1.0 -> 5.1 mid-file).
    int fch = fr->ch_layout.nb_channels;
    AVSampleFormat ffmt = (AVSampleFormat)fr->format;
    if (in_n <= 0) return 0;
    if (fch <= 0 || fch > 64
        || fr->format < 0 || fr->format >= AV_SAMPLE_FMT_NB
        || !fr->extended_data) {
        // nonsense frame: drop it and keep decoding (the decoder already
        // logged the corruption; a hard error would abandon a recoverable
        // stream — same policy as the corrupt-packet skip in
        // decode_next_frame)
        return 0;
    }
    if (fr->sample_rate != s->native_rate) {
        // A RATE change is different from a layout/format change: every
        // position (native_pos, seek targets, warmup math) is denominated
        // in open-time native samples, so converting rate-changed frames
        // would serve audio under wrong timestamps. Drop such frames —
        // positions stay exact and the resulting short read surfaces
        // through the pipeline's bad-read handling.
        return 0;
    }
    for (int p = 0; p < (av_sample_fmt_is_planar(ffmt) ? fch : 1); ++p)
        if (!fr->extended_data[p]) return 0;  // corrupt frame: missing plane
    bool mismatch = !s->swr || (int)ffmt != s->swr_in_fmt
                    || fr->sample_rate != s->swr_in_rate;
    if (!mismatch) {
        if (fr->ch_layout.order == AV_CHANNEL_ORDER_UNSPEC)
            mismatch = fch != s->swr_in_layout.nb_channels;
        else
            mismatch = av_channel_layout_compare(&fr->ch_layout,
                                                 &s->swr_in_layout) != 0;
    }
    if (mismatch) {
        if (s->swr) {
            // the old resampler's delay line holds audio that was already
            // fed; flush it before reconfiguring so no samples are lost
            size_t fbase = s->fifo.size();
            int64_t tail = av_rescale_rnd(
                swr_get_delay(s->swr, s->native_rate) + 256,
                s->out_rate, s->native_rate, AV_ROUND_UP) + 64;
            s->fifo.resize(fbase + tail);
            uint8_t* flush_planes[1] = {(uint8_t*)(s->fifo.data() + fbase)};
            int fgot = swr_convert(s->swr, flush_planes, (int)tail,
                                   nullptr, 0);
            s->fifo.resize(fbase + (fgot > 0 ? fgot : 0));
            apply_out_drop(s);
        }
        // on failure s->swr is left NULL with swr_in_* reset, so the next
        // frame re-enters this branch (no stale-config conversion) and a
        // later seek heals via seek_internal's !swr reopen path
        if (config_swr(s, &fr->ch_layout, ffmt, fr->sample_rate, fch) < 0)
            return -1;
    }

    // drop native samples still owed from a seek
    if (s->native_discard > 0) {
        if (in_n <= s->native_discard) {
            s->native_discard -= in_n;
            s->native_pos += in_n;
            return 0;
        }
        // partial: advance pointers for packed or planar layouts, using the
        // FRAME's actual properties (not the open-time stream parameters —
        // they can differ, see above)
        int skip = (int)s->native_discard;
        int bps = av_get_bytes_per_sample(ffmt);
        static thread_local std::vector<const uint8_t*> ptrs;
        int nplanes = av_sample_fmt_is_planar(ffmt) ? fch : 1;
        int stride = av_sample_fmt_is_planar(ffmt) ? bps : bps * fch;
        ptrs.assign(nplanes, nullptr);
        for (int p = 0; p < nplanes; ++p)
            ptrs[p] = fr->extended_data[p] + (int64_t)skip * stride;
        in_data = ptrs.data();
        in_n -= skip;
        s->native_pos += skip;
        s->native_discard = 0;
    }

    int64_t max_out = av_rescale_rnd(
        swr_get_delay(s->swr, fr->sample_rate) + in_n,
        s->out_rate, fr->sample_rate, AV_ROUND_UP) + 64;
    size_t base = s->fifo.size();
    s->fifo.resize(base + max_out);
    uint8_t* out_planes[1] = {(uint8_t*)(s->fifo.data() + base)};
    int got = swr_convert(s->swr, out_planes, (int)max_out, in_data, in_n);
    if (got < 0) { s->fifo.resize(base); set_err(s, "swr_convert", got); return got; }
    s->fifo.resize(base + got);
    s->native_pos += in_n;

    apply_out_drop(s);
    return 0;
}

// Pull the next decoded frame into s->frame. Returns 0, AVERROR_EOF, or a
// fatal error. Corrupt packets/read errors degrade to EOF (short read).
int decode_next_frame(BzStream* s) {
    if (!s->dec || !s->fmt) {
        // a failed reopen (file vanished mid-analysis) left no contexts:
        // report EOF instead of dereferencing null
        s->eof_out = true;
        return AVERROR_EOF;
    }
    while (true) {
        int ret = avcodec_receive_frame(s->dec, s->frame);
        if (ret == 0) return 0;
        if (ret == AVERROR_EOF) return AVERROR_EOF;
        if (ret != AVERROR(EAGAIN)) { set_err(s, "receive_frame", ret); return ret; }

        if (s->draining) continue;
        ret = av_read_frame(s->fmt, s->pkt);
        if (ret == AVERROR_EOF) {
            avcodec_send_packet(s->dec, nullptr);
            s->draining = true;
            continue;
        }
        if (ret < 0) {
            set_err(s, "read_frame", ret);
            avcodec_send_packet(s->dec, nullptr);
            s->draining = true;
            continue;
        }
        if (s->pkt->stream_index == s->stream_index) {
            ret = avcodec_send_packet(s->dec, s->pkt);
            // decoder rejecting a corrupt packet: just skip it
            (void)ret;
        }
        av_packet_unref(s->pkt);
    }
}

// Decode until the fifo holds >= want output samples or EOF.
int fill_fifo(BzStream* s, int64_t want) {
    while (!s->eof_out &&
           (int64_t)(s->fifo.size() - s->fifo_head) < want + s->out_drop) {
        int ret = decode_next_frame(s);
        if (ret == 0) {
            ret = push_frame(s, s->frame);
            av_frame_unref(s->frame);
            if (ret < 0) return ret;
            continue;
        }
        if (ret == AVERROR_EOF) {
            if (!s->swr) {  // failed reopen: nothing to flush
                s->eof_out = true;
                break;
            }
            // flush swr tail
            size_t base = s->fifo.size();
            int64_t max_out = av_rescale_rnd(
                swr_get_delay(s->swr, s->native_rate) + 256,
                s->out_rate, s->native_rate, AV_ROUND_UP) + 64;
            s->fifo.resize(base + max_out);
            uint8_t* out_planes[1] = {(uint8_t*)(s->fifo.data() + base)};
            int got = swr_convert(s->swr, out_planes, (int)max_out, nullptr, 0);
            s->fifo.resize(base + (got > 0 ? got : 0));
            apply_out_drop(s);
            s->eof_out = true;
            break;
        }
        return ret;  // fatal decode error
    }
    return 0;
}

// Resampler warmup: when converting rates, the polyphase filter needs input
// history before the target or the first few output samples ring. Feed a
// preroll whose length is a multiple of native_rate/gcd so the corresponding
// output count is an exact integer (phase-exact positioning), and drop that
// output.
void plan_warmup(BzStream* s, int64_t target_native,
                 int64_t* discard_from, int64_t* out_drop) {
    int64_t g = std::gcd((int64_t)s->native_rate, (int64_t)s->out_rate);
    int64_t unit = s->native_rate / g;
    int64_t n_units = (256 + unit - 1) / unit;
    int64_t warmup = std::min(target_native / unit, n_units) * unit;
    *discard_from = target_native - warmup;
    *out_drop = warmup * s->out_rate / s->native_rate;
}

// Position the stream so the next output sample is `target_out`.
int seek_internal(BzStream* s, int64_t target_out) {
    if (!s->fmt || !s->dec || !s->swr) {
        // a prior reopen failed (file vanished mid-analysis): retry via the
        // safe reopen path. Close any half-open contexts first (a transient
        // bad file can leave fmt set with dec/swr null — reusing that fmt in
        // avformat_open_input is UB and would leak the rest), and do NOT
        // fall into the fast path below: out_pos/fifo describe the dead
        // stream, so matching against them would serve audio from sample 0
        // labeled as the target position.
        close_internal(s);
        int ret = open_internal(s);
        if (ret < 0) {
            s->fifo.clear();
            s->fifo_head = 0;
            s->eof_out = true;
            return ret;
        }
        int64_t tn = av_rescale(target_out, s->native_rate, s->out_rate);
        plan_warmup(s, tn, &s->native_discard, &s->out_drop);
        s->out_pos = target_out;
        return 0;
    }
    int64_t target_native = av_rescale(target_out, s->native_rate, s->out_rate);

    // fast path: target is ahead within the already-buffered fifo
    int64_t buffered = (int64_t)(s->fifo.size() - s->fifo_head);
    if (target_out >= s->out_pos && target_out - s->out_pos <= buffered) {
        s->fifo_head += (size_t)(target_out - s->out_pos);
        s->out_pos = target_out;
        return 0;
    }

    bool forward = target_native >= s->native_pos;
    // forward seeks decode-and-discard when that's cheaper than a container
    // seek: always for REOPEN codecs (a reopen would recount from zero), and
    // for short hops on PTS codecs (container seek + preroll costs more)
    bool small_forward = forward &&
        (s->strategy == SEEK_REOPEN ||
         (target_native - s->native_pos) < (int64_t)s->native_rate * 20);

    if (s->strategy == SEEK_PTS && !small_forward) {
        // Container seek to a preroll point before the target, then locate
        // exactly via the first decoded frame's pts and decode-discard the
        // rest. The preroll absorbs the post-seek corrupt frame (AAC MDCT
        // overlap-add, MP3 bit-reservoir) the reference drivers document.
        AVStream* st = s->fmt->streams[s->stream_index];
        int64_t pre_native = std::max<int64_t>(
            0, target_native - s->preroll_native);
        int64_t ts = av_rescale_q(pre_native, AVRational{1, s->native_rate},
                                  st->time_base);
        if (st->start_time != AV_NOPTS_VALUE) ts += st->start_time;
        int ret = av_seek_frame(s->fmt, s->stream_index, ts,
                                AVSEEK_FLAG_BACKWARD);
        if (ret >= 0) {
            avcodec_flush_buffers(s->dec);
            s->fifo.clear(); s->fifo_head = 0;
            s->draining = false; s->eof_out = false;
            swr_init(s->swr);  // reset resampler state

            ret = decode_next_frame(s);
            int64_t landed = AV_NOPTS_VALUE;
            if (ret == 0 && s->frame->pts != AV_NOPTS_VALUE) {
                int64_t pts = s->frame->pts;
                if (st->start_time != AV_NOPTS_VALUE) pts -= st->start_time;
                landed = av_rescale_q(pts, st->time_base,
                                      AVRational{1, s->native_rate});
            }
            int64_t discard_from, out_drop;
            plan_warmup(s, target_native, &discard_from, &out_drop);
            if (ret == 0 && landed != AV_NOPTS_VALUE && landed <= discard_from) {
                s->native_pos = landed;
                s->native_discard = discard_from - landed;
                s->out_drop = out_drop;
                // the discard consumes the in-hand frame first
                int pret = push_frame(s, s->frame);
                av_frame_unref(s->frame);
                if (pret == 0) {
                    // fifo was cleared pre-decode, so anything push_frame
                    // emitted is already post-target output — keep it
                    s->out_pos = target_out;
                    return 0;
                }
            }
            if (ret == 0) av_frame_unref(s->frame);
            // pts missing/overshoot/corrupt -> fall through to reopen path
        }
        // container seek failed -> reopen
    }

    if (small_forward) {
        // decode-discard forward from current position
        int64_t discard_from, out_drop;
        plan_warmup(s, target_native, &discard_from, &out_drop);
        s->fifo_head = s->fifo.size();  // drop buffered output
        swr_init(s->swr);               // reset resampler state
        if (discard_from >= s->native_pos) {
            s->native_discard = discard_from - s->native_pos;
            s->out_drop = out_drop;
        } else {
            // target closer than one warmup: accept a sub-1e-2 transient on
            // the first few samples (cannot rewind input)
            s->native_discard = target_native - s->native_pos;
            s->out_drop = 0;
        }
        s->out_pos = target_out;
        return 0;
    }

    // safe path: reopen and count forward (bit-exact for every codec)
    close_internal(s);
    int ret = open_internal(s);
    if (ret < 0) {
        // failed reopen (e.g. file vanished mid-analysis): drop the stale
        // fifo — serving it at the new position would be silent corruption
        s->fifo.clear();
        s->fifo_head = 0;
        s->eof_out = true;
        return ret;
    }
    plan_warmup(s, target_native, &s->native_discard, &s->out_drop);
    s->out_pos = target_out;
    return 0;
}

}  // namespace

// --- output converters + the shared fifo drain ------------------------------
// One drain implementation for every wire format: fill, convert while
// copying out, advance, compact. The converter is a per-sample functor so
// each instantiation compiles to a single vectorizable loop.

static inline float conv_f32(float v) { return v; }

static inline int16_t conv_s16(float v) {
    v = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
    return (int16_t)lrintf(v * 32767.0f);
}

// Continuous mu-law companding (mu=255) to int8 [-127, 127]: the 8-bit wire
// format for bandwidth-starved host->device links. The device side inverts
// it elementwise (see models/classifier.py _to_float). Chosen over G.711's
// segmented curve because the inverse is a single expm1 on the device.
static inline int8_t conv_mulaw(float v) {
    v = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
    float m = log1pf(255.0f * fabsf(v)) * (127.0f / 5.54517744447956247f);
    int q = (int)lrintf(m);   // ln(256) = 5.5451774...
    return (int8_t)(v < 0.0f ? -q : q);
}

template <typename T, typename Conv>
static int64_t drain_fifo(BzStream* s, T* out, int64_t max_samples,
                          Conv conv) {
    // a negative count would wrap through (size_t)n below and corrupt the
    // fifo head; the Python binding can't produce one (np.empty raises
    // first) but the C ABI must not rely on that
    if (max_samples <= 0) return 0;
    if (fill_fifo(s, max_samples) < 0 && s->fifo.size() == s->fifo_head)
        return -1;
    int64_t avail = (int64_t)(s->fifo.size() - s->fifo_head);
    int64_t n = std::min(avail, max_samples);
    const float* src = s->fifo.data() + s->fifo_head;
    for (int64_t i = 0; i < n; i++) out[i] = conv(src[i]);
    s->fifo_head += (size_t)n;
    s->out_pos += n;
    // compact occasionally
    if (s->fifo_head > (1u << 20)) {
        s->fifo.erase(s->fifo.begin(), s->fifo.begin() + s->fifo_head);
        s->fifo_head = 0;
    }
    return n;
}

extern "C" {

BzStream* bz_open(const char* path, int target_rate, char* errbuf, int errlen) {
    av_log_set_level(AV_LOG_ERROR);
    auto* s = new BzStream();
    s->path = path;
    s->out_rate = target_rate;
    s->pkt = av_packet_alloc();
    s->frame = av_frame_alloc();
    if (open_internal(s) < 0) {
        if (errbuf && errlen > 0)
            snprintf(errbuf, errlen, "%s", s->error.c_str());
        av_packet_free(&s->pkt);
        av_frame_free(&s->frame);
        close_internal(s);
        delete s;
        return nullptr;
    }
    return s;
}

int bz_samplerate(BzStream* s) { return s->out_rate; }
int bz_native_samplerate(BzStream* s) { return s->native_rate; }
int bz_channels(BzStream* s) { return s->native_channels; }
int64_t bz_duration_samples(BzStream* s) { return s->duration_out; }
int64_t bz_tell(BzStream* s) { return s->out_pos; }

const char* bz_codec(BzStream* s) {
    return s->dec && s->dec->codec ? s->dec->codec->name : "";
}

int bz_strategy(BzStream* s) { return (int)s->strategy; }

int64_t bz_read(BzStream* s, float* out, int64_t max_samples) {
    return drain_fifo(s, out, max_samples, conv_f32);
}

// Read directly as int16 wire format: fused clip+scale+round during the
// fifo copy, so the pipeline's transfer dtype costs zero extra passes over
// the samples (the host here is a single shared core — every avoided numpy
// pass is wall-clock; see buzzdetect_tpu/models/classifier.py transfer_dtype).
int64_t bz_read_s16(BzStream* s, int16_t* out, int64_t max_samples) {
    return drain_fifo(s, out, max_samples, conv_s16);
}

// Read companded to the mu-law int8 wire format in the same native pass.
int64_t bz_read_mulaw(BzStream* s, int8_t* out, int64_t max_samples) {
    return drain_fifo(s, out, max_samples, conv_mulaw);
}

// Standalone one-pass converters (GIL released by ctypes) for samples that
// did not come through a BzStream — the Python fallbacks chain several
// full-array numpy passes.
void bz_quantize_s16(const float* in, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; i++) out[i] = conv_s16(in[i]);
}

void bz_mulaw_s8(const float* in, int8_t* out, int64_t n) {
    for (int64_t i = 0; i < n; i++) out[i] = conv_mulaw(in[i]);
}

int bz_seek(BzStream* s, int64_t sample) {
    if (sample < 0) sample = 0;
    s->error.clear();
    return seek_internal(s, sample);
}

int bz_last_error(BzStream* s, char* buf, int len) {
    if (s->error.empty()) return 0;
    snprintf(buf, len, "%s", s->error.c_str());
    return (int)s->error.size();
}

void bz_close(BzStream* s) {
    if (!s) return;
    close_internal(s);
    av_packet_free(&s->pkt);
    av_frame_free(&s->frame);
    delete s;
}

// --- synthetic fixture encoder (tests only) ---------------------------------
// Writes `seconds` of a deterministic multi-tone signal to `path`, encoded
// with `codec_name` (aac, wmav2, ac3, mp3 via libmp3lame, flac, pcm_s16le).
// Container is inferred from the file extension. Enables the per-codec
// seek-verification experiments the reference documents but does not ship.
int bz_encode_fixture(const char* path, const char* codec_name,
                      int sample_rate, int channels, double seconds,
                      char* errbuf, int errlen, int vbr) {
    av_log_set_level(AV_LOG_ERROR);
    AVFormatContext* fmt = nullptr;
    AVCodecContext* enc = nullptr;
    int ret = avformat_alloc_output_context2(&fmt, nullptr, nullptr, path);
    auto fail = [&](const char* what, int err) {
        char b[128] = {0};
        if (err) av_strerror(err, b, sizeof b);
        if (errbuf) snprintf(errbuf, errlen, "%s: %s", what, b);
        if (enc) avcodec_free_context(&enc);
        if (fmt) {
            if (fmt->pb) avio_closep(&fmt->pb);
            avformat_free_context(fmt);
        }
        return err ? err : -1;
    };
    if (ret < 0 || !fmt) return fail("alloc_output", ret);

    const AVCodec* codec = avcodec_find_encoder_by_name(codec_name);
    if (!codec) return fail("no encoder", 0);
    AVStream* st = avformat_new_stream(fmt, nullptr);
    if (!st) return fail("new_stream", 0);
    enc = avcodec_alloc_context3(codec);
    if (!enc) return fail("alloc_context", 0);
    enc->sample_rate = sample_rate;
    av_channel_layout_default(&enc->ch_layout, channels);
    enc->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0]
                                         : AV_SAMPLE_FMT_FLTP;
    if (vbr) {
        // true VBR (e.g. lame -V): frame sizes vary with signal complexity,
        // exercising the seek paths where byte-interpolated timestamps lie
        enc->flags |= AV_CODEC_FLAG_QSCALE;
        enc->global_quality = 5 * FF_QP2LAMBDA;
    } else {
        enc->bit_rate = 128000;
    }
    enc->time_base = AVRational{1, sample_rate};
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
        enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    ret = avcodec_open2(enc, codec, nullptr);
    if (ret < 0) return fail("encoder open", ret);
    avcodec_parameters_from_context(st->codecpar, enc);
    st->time_base = enc->time_base;

    if (!(fmt->oformat->flags & AVFMT_NOFILE)) {
        ret = avio_open(&fmt->pb, path, AVIO_FLAG_WRITE);
        if (ret < 0) return fail("avio_open", ret);
    }
    ret = avformat_write_header(fmt, nullptr);
    if (ret < 0) return fail("write_header", ret);

    AVFrame* frame = av_frame_alloc();
    AVPacket* pkt = av_packet_alloc();
    if (!frame || !pkt) {
        if (frame) av_frame_free(&frame);
        if (pkt) av_packet_free(&pkt);
        return fail("frame/packet alloc", 0);
    }
    int frame_size = enc->frame_size > 0 ? enc->frame_size : 1024;
    int64_t total = (int64_t)(seconds * sample_rate);
    int64_t pos = 0;

    SwrContext* swr = nullptr;  // float -> encoder fmt
    AVChannelLayout lay;
    av_channel_layout_default(&lay, channels);
    ret = swr_alloc_set_opts2(&swr, &lay, enc->sample_fmt, sample_rate,
                              &lay, AV_SAMPLE_FMT_FLT, sample_rate, 0,
                              nullptr);
    if (ret < 0 || !swr || swr_init(swr) < 0) {
        // swr may be null here — every other path in this function reports
        // through errbuf instead of dereferencing
        av_frame_free(&frame);
        av_packet_free(&pkt);
        if (swr) swr_free(&swr);
        return fail("swr setup", ret);
    }

    std::vector<float> buf((size_t)frame_size * channels);
    auto drain = [&](bool flush) {
        int r = avcodec_send_frame(enc, flush ? nullptr : frame);
        (void)r;
        while (avcodec_receive_packet(enc, pkt) == 0) {
            av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
            pkt->stream_index = st->index;
            av_interleaved_write_frame(fmt, pkt);
            av_packet_unref(pkt);
        }
    };

    uint32_t lcg = 0x2545F491u;  // deterministic "noise" for the vbr signal
    while (pos < total) {
        int n = (int)std::min<int64_t>(frame_size, total - pos);
        for (int i = 0; i < n; ++i) {
            double t = (double)(pos + i) / sample_rate;
            float v = (float)(0.30 * sin(2 * M_PI * 210.0 * t)
                              + 0.15 * sin(2 * M_PI * 523.0 * t)
                              + 0.05 * sin(2 * M_PI * 1277.0 * t));
            if (vbr) {
                // alternate quiet tone / dense noise every 0.25 s so the
                // encoder's per-frame bitrate genuinely varies
                bool busy = ((int64_t)(t * 4.0)) & 1;
                if (busy) {
                    lcg = lcg * 1664525u + 1013904223u;
                    v = 0.25f * v
                        + 0.5f * ((float)(lcg >> 8) / 8388608.0f - 1.0f);
                } else {
                    v *= 0.05f;
                }
            }
            for (int c = 0; c < channels; ++c)
                buf[(size_t)i * channels + c] = v;
        }
        frame->nb_samples = n;
        frame->format = enc->sample_fmt;
        av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
        frame->sample_rate = sample_rate;
        av_frame_get_buffer(frame, 0);
        const uint8_t* in[1] = {(const uint8_t*)buf.data()};
        swr_convert(swr, frame->extended_data, n, in, n);
        frame->pts = pos;
        drain(false);
        av_frame_unref(frame);
        pos += n;
    }
    drain(true);
    av_write_trailer(fmt);

    swr_free(&swr);
    av_channel_layout_uninit(&lay);
    av_frame_free(&frame);
    av_packet_free(&pkt);
    avcodec_free_context(&enc);
    if (fmt->pb) avio_closep(&fmt->pb);
    avformat_free_context(fmt);
    return 0;
}

}  // extern "C"
