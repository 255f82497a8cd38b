// The FLI / FLC frame decoder of liverrenderer_tpu_torch/io/fli.py, as
// Pillow 12.1's FliDecode.c decodes one frame: the frame chunk's subchunks
// over the image (zeroed before the first frame), in order.  fli.py keeps
// its plain Python version (`_frame_plain`) with the same contract; the
// tests hold the two equal.  Compiled with the host C++ compiler at first
// use (host_build.py) and called through ctypes.
//
// lrt_fli_frame(buf, bytes, img, xsize, ysize, status) -> what
//   ImagingFliDecode returns to ImageFile.load: 0 when the buffer holds
//   less than the frame's size (the feeder reads on), the bytes it used
//   when a COPY chunk wants more than the buffer holds, or -1 when the
//   frame is done or broken; status[0] then holds the error (0, -1
//   overrun, -2 broken, -3 unknown chunk).  img is xsize * ysize bytes,
//   rows in order.  Subchunks: 4 and 11 (colour: read by the opener), 7
//   (SS2, word delta), 12 (LC, byte delta), 13 (BLACK), 15 (BRUN), 16
//   (COPY), 18 (postage stamp, skipped); each bounded by the bytes left
//   from its own start.

#include <cstdint>
#include <cstring>

namespace {

inline int i16(const uint8_t* p) { return p[0] | (p[1] << 8); }

inline int32_t i32(const uint8_t* p) {
  return static_cast<int32_t>(static_cast<uint32_t>(p[0]) |
                              (static_cast<uint32_t>(p[1]) << 8) |
                              (static_cast<uint32_t>(p[2]) << 16) |
                              (static_cast<uint32_t>(p[3]) << 24));
}

constexpr int kOverrun = -1, kBroken = -2, kUnknown = -3;

}  // namespace

extern "C" int64_t lrt_fli_frame(const uint8_t* buf, int64_t bytes,
                                 uint8_t* img, int xsize, int ysize,
                                 int32_t* status) {
  status[0] = 0;
  if (bytes < 4) return 0;
  const uint8_t* ptr = buf;
  // the frame's size unsigned; one pad byte allowed
  const int64_t framesize = static_cast<uint32_t>(i32(ptr));
  if (bytes + (bytes % 2) < framesize) return 0;
  if (bytes < 8) {
    status[0] = kOverrun;
    return -1;
  }
  if (i16(ptr + 4) != 0xF1FA) {
    status[0] = kUnknown;
    return -1;
  }
  const int chunks = i16(ptr + 6);
  ptr += 16;
  bytes -= 16;
  auto row = [&](int y) { return img + static_cast<int64_t>(y) * xsize; };
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) {
      status[0] = kOverrun;
      return -1;
    }
    const uint8_t* data = ptr + 6;
    // the data may not pass the bytes left from this subchunk's start
    auto oob = [&](int64_t n) { return data + n > ptr + bytes; };
    switch (i16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2: word delta
        const int lines = i16(data);
        data += 2;
        int l = 0, y = 0;
        for (; l < lines && y < ysize; l++, y++) {
          uint8_t* out = row(y);
          if (oob(2)) { status[0] = kOverrun; return -1; }
          int packets = i16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;  // skip lines
              if (y >= ysize) { status[0] = kOverrun; return -1; }
              out = row(y);
            } else {
              out[xsize - 1] = static_cast<uint8_t>(packets);
            }
            if (oob(2)) { status[0] = kOverrun; return -1; }
            packets = i16(data);
            data += 2;
          }
          int p = 0, x = 0;
          for (; p < packets; p++) {
            if (oob(2)) { status[0] = kOverrun; return -1; }
            x += data[0];
            if (data[1] >= 128) {
              if (oob(4)) { status[0] = kOverrun; return -1; }
              const int i = 256 - data[1];
              if (x + i + i > xsize) break;
              for (int j = 0; j < i; j++) {
                out[x++] = data[2];
                out[x++] = data[3];
              }
              data += 4;
            } else {
              const int i = 2 * static_cast<int>(data[1]);
              if (x + i > xsize) break;
              if (oob(2 + i)) { status[0] = kOverrun; return -1; }
              std::memcpy(out + x, data + 2, i);
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) { status[0] = kOverrun; return -1; }
        break;
      }
      case 12: {  // LC: byte delta
        int y = i16(data);
        const int ymax = y + i16(data + 2);
        data += 4;
        for (; y < ymax && y < ysize; y++) {
          uint8_t* out = row(y);
          if (oob(1)) { status[0] = kOverrun; return -1; }
          const int packets = *data++;
          int p = 0, x = 0, i = 0;
          for (; p < packets; p++, x += i) {
            if (oob(2)) { status[0] = kOverrun; return -1; }
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > xsize) break;
              if (oob(3)) { status[0] = kOverrun; return -1; }
              std::memset(out + x, data[2], i);
              data += 3;
            } else {
              i = data[1];
              if (x + i > xsize) break;
              if (oob(2 + i)) { status[0] = kOverrun; return -1; }
              std::memcpy(out + x, data + 2, i);
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) { status[0] = kOverrun; return -1; }
        break;
      }
      case 13:  // BLACK
        std::memset(img, 0, static_cast<size_t>(xsize) * ysize);
        break;
      case 15: {  // BRUN: byte run length
        for (int y = 0; y < ysize; y++) {
          uint8_t* out = row(y);
          data += 1;  // the packet count, ignored
          int x = 0, i = 0;
          for (; x < xsize; x += i) {
            if (oob(2)) { status[0] = kOverrun; return -1; }
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > xsize) break;
              if (oob(i + 1)) { status[0] = kOverrun; return -1; }
              std::memcpy(out + x, data + 1, i);
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > xsize) break;
              std::memset(out + x, data[1], i);
              data += 2;
            }
          }
          if (x != xsize) { status[0] = kOverrun; return -1; }
        }
        break;
      }
      case 16:  // COPY
        if (INT32_MAX / xsize < ysize) { status[0] = kOverrun; return -1; }
        if (oob(static_cast<int64_t>(xsize) * ysize)) return ptr - buf;
        std::memcpy(img, data, static_cast<size_t>(xsize) * ysize);
        break;
      default:
        status[0] = kUnknown;
        return -1;
    }
    const int64_t advance = i32(ptr);
    if (advance == 0) { status[0] = kBroken; return -1; }
    if (advance < 0 || advance > bytes) { status[0] = kOverrun; return -1; }
    ptr += advance;
    bytes -= advance;
  }
  return -1;
}
