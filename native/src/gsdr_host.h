/* gsdr_host — native host-side runtime for the gsdr_tpu framework.
 *
 * The reference library's native layer is a CUDA C ABI + launch harness
 * (/root/reference/include/gsdr/gsdr.h, src/cuComplexOperatorOverloads.cuh
 * :74-93). In this framework the device math lives in XLA/Pallas; the
 * native layer instead owns what a production SDR deployment needs on the
 * host CPU, off the Python GIL:
 *
 *   - a lock-free single-producer/single-consumer sample ring buffer
 *     (radio -> framer handoff),
 *   - IQ stream framing: fixed-size blocks with overlap-save history,
 *     int8/int16 -> normalized planar float32 staging (the reference's
 *     gsdrInt8ToNormFloat semantics, include/gsdr/conversion.h:24-29:
 *     out = max(-1, x/127)),
 *   - 2-bit symbol pack/unpack for the QPSK byte I/O convention
 *     (4 symbols/byte LSB-first, /root/reference/src/qpsk.cu:121-123).
 *
 * Exported as a C ABI (mirroring the reference's GSDR_C_LINKAGE convention,
 * include/gsdr/util.h:19-29) and bound from Python with ctypes
 * (gsdr_tpu/runtime/host.py).
 */

#ifndef GSDR_HOST_H
#define GSDR_HOST_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- error codes (cudaError_t analog; 0 == success) ---- */
enum GsdrHostStatus {
  GSDR_HOST_OK = 0,
  GSDR_HOST_EINVAL = 1,
  GSDR_HOST_EAGAIN = 2,   /* not enough data/space yet */
  GSDR_HOST_ENOMEM = 3,
};

/* ---- SPSC ring buffer of interleaved complex float32 (re, im) ---- */
typedef struct GsdrRing GsdrRing;

GsdrRing* gsdr_ring_create(size_t capacity_samples);
void gsdr_ring_destroy(GsdrRing* ring);
size_t gsdr_ring_capacity(const GsdrRing* ring);
size_t gsdr_ring_readable(const GsdrRing* ring);
size_t gsdr_ring_writable(const GsdrRing* ring);
/* Producer: push n interleaved complex samples (2n floats). Returns samples
 * actually written (< n when full). */
size_t gsdr_ring_write(GsdrRing* ring, const float* interleaved, size_t n);
/* Consumer: pop up to n samples into separate re/im planes. */
size_t gsdr_ring_read_planar(GsdrRing* ring, float* re, float* im, size_t n);

/* ---- overlap-save block framer ----
 * Maintains a (history = num_taps - 1)-sample tail so that every emitted
 * block is history + block_len samples, planar float32 — exactly the
 * layout gsdr_tpu streaming steps consume. Replaces the reference's
 * caller-managed numLowPassTaps overlap (include/gsdr/fm.h:26) at the
 * host ingest boundary. */
typedef struct GsdrFramer GsdrFramer;

GsdrFramer* gsdr_framer_create(size_t block_len, size_t history);
void gsdr_framer_destroy(GsdrFramer* framer);
/* Pull one framed block from `ring` into re/im buffers of length
 * history + block_len. Returns GSDR_HOST_EAGAIN if the ring holds fewer
 * than block_len new samples. Also outputs the global index of the first
 * *new* sample in the block. */
int gsdr_framer_next(GsdrFramer* framer, GsdrRing* ring,
                     float* re, float* im, uint64_t* first_sample_index);

/* ---- sample format staging ---- */
/* int8 interleaved IQ -> planar normalized float32: out = max(-1, x/127)
 * (include/gsdr/conversion.h:24-29; -128 and -127 both map to -1.0). */
void gsdr_int8_iq_to_planar_f32(const int8_t* interleaved, size_t n,
                                float* re, float* im);
/* int16 interleaved IQ -> planar float32 scaled by 1/32767, clamped. */
void gsdr_int16_iq_to_planar_f32(const int16_t* interleaved, size_t n,
                                 float* re, float* im);
/* float32 interleaved IQ -> planar. */
void gsdr_f32_iq_to_planar(const float* interleaved, size_t n,
                           float* re, float* im);
/* planar -> interleaved float32 (for writing IQ recordings). */
void gsdr_planar_to_f32_iq(const float* re, const float* im, size_t n,
                           float* interleaved);

/* ---- QPSK byte packing (src/qpsk.cu:121-123 convention) ---- */
/* bytes (4 symbols each, LSB-first 2-bit fields) -> symbol values 0..3 */
void gsdr_unpack_2bit(const uint8_t* bytes, size_t num_symbols,
                      uint8_t* symbols);
/* symbol values 0..3 -> packed bytes (num_symbols need not be %4; tail
 * fields zero-filled). out must hold (num_symbols+3)/4 bytes. */
void gsdr_pack_2bit(const uint8_t* symbols, size_t num_symbols,
                    uint8_t* bytes);

#ifdef __cplusplus
}
#endif

#endif /* GSDR_HOST_H */
