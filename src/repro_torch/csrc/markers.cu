// Events for the stream's device markers (engine/spans.py) and its copy
// ring (engine/stream.py): made on a device, recorded on a stream, waited
// on by another stream, one batch's five markers read against the batch
// before once they ran, freed.  Plain runtime calls behind one C call
// each, so that a batch's events cost the host a few microseconds.  Each
// returns a cudaError_t (0: success).
#include <cuda_runtime.h>

extern "C" int repro_event_create(int device, void** out) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  cudaEvent_t ev = nullptr;
  if (err == cudaSuccess) err = cudaEventCreate(&ev);
  if (prev != device) {
    cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  *out = ev;
  return static_cast<int>(err);
}

extern "C" int repro_event_destroy(void* ev) {
  return static_cast<int>(cudaEventDestroy(static_cast<cudaEvent_t>(ev)));
}

extern "C" int repro_event_record(void* ev, void* stream) {
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(ev),
                                          static_cast<cudaStream_t>(stream)));
}

// `stream` runs nothing enqueued after this call before `ev` ran.
extern "C" int repro_stream_wait(void* stream, void* ev) {
  return static_cast<int>(
      cudaStreamWaitEvent(static_cast<cudaStream_t>(stream),
                          static_cast<cudaEvent_t>(ev), 0));
}

extern "C" int repro_event_synchronize(void* ev) {
  return static_cast<int>(
      cudaEventSynchronize(static_cast<cudaEvent_t>(ev)));
}

// ms from `prev` to `m0`, from `m0` to `m1`, from `r` to `s` and from
// `s` to `m2` into out[0..3] once `m2` ran; cudaErrorNotReady while it
// has not.  `m0` and `m1` bracket the batch's copies on the copy stream,
// `r`, `s` and `m2` lie on the compute stream in that order, and `s`
// follows the compute stream's wait for the copies, so `m2` running
// means all six ran (`prev`, the marked batch before's `m0`, ran first).
extern "C" int repro_marker_times(void* prev, void* m0, void* m1, void* r,
                                  void* s, void* m2, float* out) {
  cudaError_t err = cudaEventQuery(static_cast<cudaEvent_t>(m2));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* from[4] = {prev, m0, r, s};
  void* to[4] = {m0, m1, s, m2};
  for (int i = 0; i < 4; ++i) {
    err = cudaEventElapsedTime(&out[i], static_cast<cudaEvent_t>(from[i]),
                               static_cast<cudaEvent_t>(to[i]));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// ms from `a` to `b`, both of which ran.
extern "C" int repro_event_elapsed(void* a, void* b, float* out) {
  return static_cast<int>(cudaEventElapsedTime(
      out, static_cast<cudaEvent_t>(a), static_cast<cudaEvent_t>(b)));
}
