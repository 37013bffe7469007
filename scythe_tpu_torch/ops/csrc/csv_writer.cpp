// The port's CSV writer: a header line, then each row's values as "%.17g",
// comma-joined, the bytes native/scythe_io.cpp's write_csv writes.  A plain
// C function that touches no Python object, so ctypes calls it with the GIL
// released and the run loop goes on enqueueing replays while its writer
// thread formats an output.  Built with the host C++ compiler at first use
// (ops/_build.py load_host).

#include <cerrno>
#include <cstdio>
#include <string>

extern "C" int scythe_write_csv(const char* path, const char* header, long long header_len,
                                const double* data, long long nrows, long long ncols) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return errno ? errno : EIO;
    std::fwrite(header, 1, (size_t)header_len, f);
    std::string line;
    line.reserve((size_t)ncols * 26);
    char num[64];
    for (long long r = 0; r < nrows; ++r) {
        line.clear();
        for (long long c = 0; c < ncols; ++c) {
            int n = std::snprintf(num, sizeof num, "%.17g", data[r * ncols + c]);
            line.append(num, (size_t)n);
            if (c + 1 < ncols) line.push_back(',');
        }
        line.push_back('\n');
        std::fwrite(line.data(), 1, line.size(), f);
    }
    int err = std::ferror(f) ? (errno ? errno : EIO) : 0;
    if (std::fclose(f) != 0 && !err) err = errno ? errno : EIO;
    return err;
}
