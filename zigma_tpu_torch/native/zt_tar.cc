// zt_tar — indexed POSIX tar reader for webdataset shards.
//
// Native counterpart of the Python tarfile path in
// zigma_tpu_torch/data/wds.py (the reference's data plane is the webdataset
// package's Python tar loop, reference: datasets/wds_dataloader.py:147-166).
// Python's tarfile costs ~10 us/member in header parsing and object churn;
// this indexes the archive once (header walk) and serves members with
// pread(2), so the input pipeline keeps the card's steps fed from the host
// CPU.
//
// Exposed as a plain C ABI for ctypes (no pybind11 needed).
// Supports ustar, GNU long names ('L' entries), and PAX extended headers
// ('x' entries, the Python tarfile default) for path/size overrides; skips
// non-file members. Not supported (webdataset never writes them): sparse
// files, 'g' global overrides other than being skipped.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Member {
  std::string name;
  uint64_t offset;  // payload offset in the archive
  uint64_t size;
};

struct Archive {
  int fd = -1;
  std::vector<Member> members;
};

// tar numeric fields: octal ASCII, or base-256 (GNU) when the high bit of
// the first byte is set.
uint64_t parse_num(const char* p, size_t n) {
  if (static_cast<unsigned char>(p[0]) & 0x80) {
    uint64_t v = static_cast<unsigned char>(p[0]) & 0x7f;
    for (size_t i = 1; i < n; i++)
      v = (v << 8) | static_cast<unsigned char>(p[i]);
    return v;
  }
  uint64_t v = 0;
  for (size_t i = 0; i < n && p[i]; i++) {
    if (p[i] < '0' || p[i] > '7') continue;
    v = (v << 3) | static_cast<uint64_t>(p[i] - '0');
  }
  return v;
}

bool index_archive(Archive* a) {
  struct stat st;
  if (fstat(a->fd, &st) != 0) return false;
  const uint64_t fsize = static_cast<uint64_t>(st.st_size);
  uint64_t off = 0;
  char hdr[512];
  std::string pending_longname;
  // PAX overrides for the NEXT entry; sentinel = no override.  'size'
  // matters for members >= 8 GiB, where the octal header field cannot hold
  // the real size (Python tarfile writes PAX by default) — using the stale
  // header size would desync every subsequent offset.
  constexpr uint64_t kNoSize = ~uint64_t(0);
  uint64_t pending_size = kNoSize;

  while (off + 512 <= fsize) {
    if (pread(a->fd, hdr, 512, static_cast<off_t>(off)) != 512) return false;
    // two zero blocks = end of archive; a single zero block also terminates
    bool all_zero = true;
    for (int i = 0; i < 512; i++)
      if (hdr[i]) { all_zero = false; break; }
    if (all_zero) break;

    uint64_t size = parse_num(hdr + 124, 12);
    const char typeflag = hdr[156];
    const uint64_t payload = off + 512;

    if (typeflag == 'L') {  // GNU long name: payload is the next entry's name
      std::vector<char> buf(size + 1, 0);
      if (pread(a->fd, buf.data(), size, static_cast<off_t>(payload)) !=
          static_cast<ssize_t>(size))
        return false;
      pending_longname.assign(buf.data());
    } else if (typeflag == 'x') {  // PAX extended header: "len key=value\n"
      std::vector<char> buf(size, 0);
      if (pread(a->fd, buf.data(), size, static_cast<off_t>(payload)) !=
          static_cast<ssize_t>(size))
        return false;
      size_t pos = 0;
      while (pos < size) {
        // record length prefix (decimal, includes itself and the newline)
        size_t sp = pos;
        while (sp < size && buf[sp] != ' ') sp++;
        if (sp >= size) break;
        unsigned long reclen = strtoul(&buf[pos], nullptr, 10);
        const size_t lenlen = sp + 1 - pos;  // digits + space
        // malformed reclen (0, shorter than its own prefix, or past the
        // buffer) would underflow the value length below — stop parsing
        if (reclen <= lenlen || pos + reclen > size) break;
        std::string rec(&buf[sp + 1], reclen - lenlen - 1);  // drop \n
        size_t eq = rec.find('=');
        if (eq != std::string::npos) {
          const std::string key = rec.substr(0, eq);
          if (key == "path")
            pending_longname = rec.substr(eq + 1);
          else if (key == "size")
            pending_size = strtoull(rec.c_str() + eq + 1, nullptr, 10);
        }
        pos += reclen;
      }
    } else if (typeflag == '0' || typeflag == '\0') {  // regular file
      if (pending_size != kNoSize) {
        size = pending_size;
        pending_size = kNoSize;
      }
      std::string name;
      if (!pending_longname.empty()) {
        name.swap(pending_longname);
      } else {
        char prefix[156] = {0};
        memcpy(prefix, hdr + 345, 155);
        char nm[101] = {0};
        memcpy(nm, hdr, 100);
        name = prefix[0] ? std::string(prefix) + "/" + nm : std::string(nm);
      }
      // pre-POSIX convention: REGTYPE with a trailing '/' is a directory
      // (Python tarfile normalizes these to DIRTYPE and skips them)
      if (!name.empty() && name.back() != '/')
        a->members.push_back({std::move(name), payload, size});
    } else {
      // non-file entries consume any pending PAX/longname overrides
      pending_longname.clear();
      pending_size = kNoSize;
    }
    const uint64_t padded = (size + 511) & ~uint64_t(511);
    off = payload + padded;
  }
  return true;
}

}  // namespace

extern "C" {

void* zt_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
#ifdef POSIX_FADV_SEQUENTIAL
  posix_fadvise(fd, 0, 0, POSIX_FADV_SEQUENTIAL);
#endif
  auto* a = new Archive();
  a->fd = fd;
  if (!index_archive(a)) {
    close(fd);
    delete a;
    return nullptr;
  }
  return a;
}

long zt_count(void* h) {
  return static_cast<long>(static_cast<Archive*>(h)->members.size());
}

const char* zt_name(void* h, long i) {
  auto* a = static_cast<Archive*>(h);
  if (i < 0 || i >= static_cast<long>(a->members.size())) return nullptr;
  return a->members[i].name.c_str();
}

long zt_size(void* h, long i) {
  auto* a = static_cast<Archive*>(h);
  if (i < 0 || i >= static_cast<long>(a->members.size())) return -1;
  return static_cast<long>(a->members[i].size);
}

// read member i into buf (caller-allocated, >= zt_size). returns bytes read.
long zt_read(void* h, long i, void* buf, long cap) {
  auto* a = static_cast<Archive*>(h);
  if (i < 0 || i >= static_cast<long>(a->members.size())) return -1;
  const Member& m = a->members[i];
  if (cap < static_cast<long>(m.size)) return -1;
  ssize_t got = pread(a->fd, buf, m.size, static_cast<off_t>(m.offset));
  return static_cast<long>(got);
}

void zt_close(void* h) {
  auto* a = static_cast<Archive*>(h);
  if (a) {
    if (a->fd >= 0) close(a->fd);
    delete a;
  }
}

}  // extern "C"
