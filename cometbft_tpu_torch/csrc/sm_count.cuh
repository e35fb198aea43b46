// The SM count of the current device, asked of the runtime once per device:
// the attribute query costs more host time than the kernels it sizes.
#pragma once

#include <cuda_runtime.h>

static inline int sm_count() {
  constexpr int MAX_DEVICES = 64;
  static int sms_of[MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < MAX_DEVICES && sms_of[dev] > 0) return sms_of[dev];
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) sms = 1;
  if (dev >= 0 && dev < MAX_DEVICES) sms_of[dev] = sms;
  return sms;
}
