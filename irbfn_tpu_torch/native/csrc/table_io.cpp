// Memory-mapped solution-table store — the framework's native data loader.
//
// Role: the reference stores multi-GB solver tables as npz and loads them
// whole into RAM (train_nmpc_frenet.py:48). For 10^8+-row lattices that is
// the datagen/training bottleneck on the host side. This store writes a
// fixed-layout binary file (header + row-major f32 blocks) that supports
//   - O(1) open via mmap (no decompress/copy),
//   - random row-range reads for permutation mini-batching,
//   - append-mode writing so sharded datagen chunks stream to disk.
// C ABI for ctypes; no external dependencies.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x4952424654424Cu;  // "IRBFTBL"
constexpr uint32_t kVersion = 1;

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t in_dim;
  uint32_t out_dim;
  uint32_t reserved;
  uint64_t n_rows;
};

struct Table {
  int fd = -1;
  void* map = nullptr;
  size_t map_size = 0;
  Header hdr{};
};

size_t row_bytes(const Header& h) {
  return sizeof(float) * (h.in_dim + h.out_dim + 1);  // +1 validity flag
}

}  // namespace

extern "C" {

// Create a new table file with the given dims; returns 0 on success.
int table_create(const char* path, uint32_t in_dim, uint32_t out_dim) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  Header h{kMagic, kVersion, in_dim, out_dim, 0, 0};
  const size_t n = std::fwrite(&h, sizeof(Header), 1, f);
  std::fclose(f);
  return n == 1 ? 0 : 2;
}

// Append rows: inputs (n, in_dim), outputs (n, out_dim), valid (n,) — all
// f32, row-major. Updates the header count. Returns 0 on success.
int table_append(const char* path, const float* inputs, const float* outputs,
                 const float* valid, uint64_t n) {
  FILE* f = std::fopen(path, "rb+");
  if (!f) return 1;
  Header h;
  if (std::fread(&h, sizeof(Header), 1, f) != 1 || h.magic != kMagic) {
    std::fclose(f);
    return 2;
  }
  std::fseek(f, 0, SEEK_END);
  for (uint64_t i = 0; i < n; ++i) {
    std::fwrite(inputs + i * h.in_dim, sizeof(float), h.in_dim, f);
    std::fwrite(outputs + i * h.out_dim, sizeof(float), h.out_dim, f);
    std::fwrite(valid + i, sizeof(float), 1, f);
  }
  h.n_rows += n;
  std::fseek(f, 0, SEEK_SET);
  std::fwrite(&h, sizeof(Header), 1, f);
  std::fclose(f);
  return 0;
}

// Open via mmap. Returns an opaque handle (0 on failure).
void* table_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  Table* t = new Table();
  t->fd = fd;
  t->map = map;
  t->map_size = st.st_size;
  std::memcpy(&t->hdr, map, sizeof(Header));
  if (t->hdr.magic != kMagic) {
    munmap(map, st.st_size);
    ::close(fd);
    delete t;
    return nullptr;
  }
  return t;
}

uint64_t table_rows(void* handle) { return static_cast<Table*>(handle)->hdr.n_rows; }
uint32_t table_in_dim(void* handle) { return static_cast<Table*>(handle)->hdr.in_dim; }
uint32_t table_out_dim(void* handle) { return static_cast<Table*>(handle)->hdr.out_dim; }

// Gather rows by index into caller buffers; returns number of rows copied.
uint64_t table_gather(void* handle, const int64_t* indices, uint64_t n,
                      float* inputs, float* outputs, float* valid) {
  Table* t = static_cast<Table*>(handle);
  const Header& h = t->hdr;
  const size_t rb = row_bytes(h);
  const char* base = static_cast<const char*>(t->map) + sizeof(Header);
  uint64_t copied = 0;
  for (uint64_t i = 0; i < n; ++i) {
    const int64_t idx = indices[i];
    if (idx < 0 || static_cast<uint64_t>(idx) >= h.n_rows) continue;
    const char* row = base + static_cast<size_t>(idx) * rb;
    std::memcpy(inputs + copied * h.in_dim, row, sizeof(float) * h.in_dim);
    std::memcpy(outputs + copied * h.out_dim,
                row + sizeof(float) * h.in_dim, sizeof(float) * h.out_dim);
    std::memcpy(valid + copied,
                row + sizeof(float) * (h.in_dim + h.out_dim), sizeof(float));
    ++copied;
  }
  return copied;
}

// Contiguous range read [start, start+n): returns rows copied.
uint64_t table_read_range(void* handle, uint64_t start, uint64_t n,
                          float* inputs, float* outputs, float* valid) {
  Table* t = static_cast<Table*>(handle);
  const Header& h = t->hdr;
  if (start >= h.n_rows) return 0;
  const uint64_t end = (start + n > h.n_rows) ? h.n_rows : start + n;
  const size_t rb = row_bytes(h);
  const char* base = static_cast<const char*>(t->map) + sizeof(Header);
  for (uint64_t i = start; i < end; ++i) {
    const char* row = base + static_cast<size_t>(i) * rb;
    const uint64_t j = i - start;
    std::memcpy(inputs + j * h.in_dim, row, sizeof(float) * h.in_dim);
    std::memcpy(outputs + j * h.out_dim, row + sizeof(float) * h.in_dim,
                sizeof(float) * h.out_dim);
    std::memcpy(valid + j, row + sizeof(float) * (h.in_dim + h.out_dim),
                sizeof(float));
  }
  return end - start;
}

void table_close(void* handle) {
  Table* t = static_cast<Table*>(handle);
  if (t->map) munmap(t->map, t->map_size);
  if (t->fd >= 0) ::close(t->fd);
  delete t;
}

}  // extern "C"
