// Test helper: writes OpenEXR files with the system OpenEXR library, in
// every codec and layout the port's reader (liverrenderer_tpu_torch/io/
// exr.py) decodes, so that tests can hold the port's decoder against the
// library's files.  It is built at test time (tests/test_torch_exr_codecs.py
// `exr_writer`) with the flags of native/Makefile:
//
//   g++ -O2 -std=c++17 -Wall -I/usr/include/OpenEXR -I/usr/include/Imath
//       -o exr_writer tests/torch_exr_writer.cpp
//       -lOpenEXR-3_1 -lImath-3_1 -lIex-3_1 -lIlmThread-3_1 -lz
//
//   exr_writer OUT COMPRESSION LAYOUT XMIN YMIN W H MANIFEST DATA
//
// COMPRESSION: none rle zips zip piz pxr24 b44 b44a dwaa dwab, the DWA
// codecs optionally with their level as "dwaa:45" (dwaCompressionLevel).
// LAYOUT: scanline, tiled (one level), mipmap_down, mipmap_up, ripmap_down,
// ripmap_up (16 x 8 tiles), multipart (part 0 a scanline image of the
// data, part 1 a tiled image of the same channels), yc (an RgbaOutputFile
// in luminance/chroma mode: Y, RY and BY, the chroma subsampled 2 x 2, of
// half R, G, B(, A) channels), deep_scanline or deep_tiled (a deep part).
// MANIFEST: one line per channel, "NAME TYPE PLINEAR" with TYPE one of
// uint, half, float.  DATA: each channel's W*H values in that type, row
// major, channel after channel in manifest order.  The data window starts
// at (XMIN, YMIN); the levels of a mip- or ripmap above level 0 take the
// top-left corner of the same data.  A deep layout's DATA begins with the
// W*H uint32 sample counts, row major; each channel's data then holds one
// value per sample, pixel after pixel.
//
// The committed fixture tests/data/torch_sky_piz.exr was made with it:
// liver_proxy.sky_map(1024, 512) as half R, G, B channels, PIZ, scanline,
// data window at (0, 0) (tests/test_torch_exr_codecs.py
// `write_with_openexr(path, {"R": .., "G": .., "B": ..}, "piz")`).

#include <ImfChannelList.h>
#include <ImfDeepFrameBuffer.h>
#include <ImfDeepScanLineOutputFile.h>
#include <ImfDeepTiledOutputFile.h>
#include <ImfFrameBuffer.h>
#include <ImfHeader.h>
#include <ImfMultiPartOutputFile.h>
#include <ImfOutputFile.h>
#include <ImfOutputPart.h>
#include <ImfPartType.h>
#include <ImfRgbaFile.h>
#include <ImfTiledOutputFile.h>
#include <ImfTiledOutputPart.h>
#include <ImathBox.h>

#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Chan {
    std::string name;
    Imf::PixelType type;
    bool linear;
    std::vector<char> data;
};

size_t type_size(Imf::PixelType t) { return t == Imf::HALF ? 2 : 4; }

Imf::Compression compression(const std::string& s) {
    static const std::map<std::string, Imf::Compression> m = {
        {"none", Imf::NO_COMPRESSION},   {"rle", Imf::RLE_COMPRESSION},
        {"zips", Imf::ZIPS_COMPRESSION}, {"zip", Imf::ZIP_COMPRESSION},
        {"piz", Imf::PIZ_COMPRESSION},   {"pxr24", Imf::PXR24_COMPRESSION},
        {"b44", Imf::B44_COMPRESSION},   {"b44a", Imf::B44A_COMPRESSION},
        {"dwaa", Imf::DWAA_COMPRESSION}, {"dwab", Imf::DWAB_COMPRESSION}};
    return m.at(s.substr(0, s.find(':')));
}

// the frame buffer of channel data whose (xmin, ymin) pixel is data[0]
Imf::FrameBuffer frame(std::vector<Chan>& chans, int xmin, int ymin, int w) {
    Imf::FrameBuffer fb;
    for (auto& c : chans) {
        const size_t ts = type_size(c.type);
        char* base = c.data.data() - (static_cast<long long>(ymin) * w + xmin)
                                         * static_cast<long long>(ts);
        fb.insert(c.name, Imf::Slice(c.type, base, ts, ts * w));
    }
    return fb;
}

Imf::Header header(const std::vector<Chan>& chans, int xmin, int ymin, int w,
                   int h, Imf::Compression comp) {
    Imath::Box2i dw(Imath::V2i(xmin, ymin),
                    Imath::V2i(xmin + w - 1, ymin + h - 1));
    Imf::Header hdr(dw, dw);
    hdr.compression() = comp;
    for (const auto& c : chans)
        hdr.channels().insert(c.name, Imf::Channel(c.type, 1, 1, c.linear));
    return hdr;
}

template <class File>
void write_levels(File& out, int mode_levels_x, int mode_levels_y,
                  bool ripmap) {
    if (!ripmap) {
        for (int l = 0; l < mode_levels_x; ++l)
            out.writeTiles(0, out.numXTiles(l) - 1, 0, out.numYTiles(l) - 1,
                           l);
        return;
    }
    for (int ly = 0; ly < mode_levels_y; ++ly)
        for (int lx = 0; lx < mode_levels_x; ++lx)
            out.writeTiles(0, out.numXTiles(lx) - 1, 0, out.numYTiles(ly) - 1,
                           lx, ly);
}

// a deep part: the sample counts, then per channel one value per sample
void write_deep(const std::string& out, const std::string& layout,
                Imf::Header hdr, std::vector<Chan>& chans,
                std::vector<unsigned>& counts, int xmin, int ymin, int w,
                int h) {
    const long long off = static_cast<long long>(ymin) * w + xmin;
    Imf::DeepFrameBuffer fb;
    fb.insertSampleCountSlice(Imf::Slice(
        Imf::UINT, reinterpret_cast<char*>(counts.data() - off),
        sizeof(unsigned), sizeof(unsigned) * w));
    // per channel, each pixel's pointer to its first sample
    std::vector<std::vector<char*>> ptrs(chans.size());
    for (size_t i = 0; i < chans.size(); ++i) {
        const size_t ts = type_size(chans[i].type);
        ptrs[i].resize(counts.size());
        size_t pos = 0;
        for (size_t p = 0; p < counts.size(); ++p) {
            ptrs[i][p] = chans[i].data.data() + pos * ts;
            pos += counts[p];
        }
        fb.insert(chans[i].name,
                  Imf::DeepSlice(chans[i].type,
                                 reinterpret_cast<char*>(ptrs[i].data() - off),
                                 sizeof(char*), sizeof(char*) * w, ts));
    }
    if (layout == "deep_scanline") {
        hdr.setType(Imf::DEEPSCANLINE);
        Imf::DeepScanLineOutputFile file(out.c_str(), hdr);
        file.setFrameBuffer(fb);
        file.writePixels(h);
    } else {
        hdr.setType(Imf::DEEPTILE);
        hdr.setTileDescription(Imf::TileDescription(16, 8, Imf::ONE_LEVEL));
        Imf::DeepTiledOutputFile file(out.c_str(), hdr);
        file.setFrameBuffer(fb);
        file.writeTiles(0, file.numXTiles() - 1, 0, file.numYTiles() - 1);
    }
}

// half R, G, B(, A) channels through an RgbaOutputFile in YC mode
void write_yc(const std::string& out, const Imf::Header& hdr,
              const std::vector<Chan>& chans, int xmin, int ymin, int w,
              int h) {
    std::vector<Imf::Rgba> px(static_cast<size_t>(w) * h,
                              Imf::Rgba(0, 0, 0, 1));
    bool alpha = false;
    for (const auto& c : chans) {
        const half* v = reinterpret_cast<const half*>(c.data.data());
        for (size_t i = 0; i < px.size(); ++i) {
            if (c.name == "R") px[i].r = v[i];
            if (c.name == "G") px[i].g = v[i];
            if (c.name == "B") px[i].b = v[i];
            if (c.name == "A") px[i].a = v[i];
        }
        alpha = alpha || c.name == "A";
    }
    Imf::Header yc(hdr.displayWindow(), hdr.dataWindow());
    yc.compression() = hdr.compression();
    Imf::RgbaOutputFile file(out.c_str(), yc,
                             alpha ? Imf::WRITE_YCA : Imf::WRITE_YC);
    file.setFrameBuffer(px.data() - (static_cast<long long>(ymin) * w + xmin),
                        1, w);
    file.writePixels(h);
}

}  // namespace

int main(int argc, char** argv) {
    if (argc != 10) {
        std::cerr << "usage: exr_writer OUT COMPRESSION LAYOUT XMIN YMIN W H "
                     "MANIFEST DATA\n";
        return 2;
    }
    try {
        const std::string out = argv[1], layout = argv[3];
        const std::string comp_name = argv[2];
        const Imf::Compression comp = compression(comp_name);
        const int xmin = std::stoi(argv[4]), ymin = std::stoi(argv[5]);
        const int w = std::stoi(argv[6]), h = std::stoi(argv[7]);
        std::vector<Chan> chans;
        std::ifstream man(argv[8]);
        std::ifstream data(argv[9], std::ios::binary);
        std::string line;
        const bool deep = layout.rfind("deep", 0) == 0;
        std::vector<unsigned> counts;
        size_t samples = static_cast<size_t>(w) * h;
        if (deep) {
            counts.resize(samples);
            data.read(reinterpret_cast<char*>(counts.data()),
                      counts.size() * sizeof(unsigned));
            samples = 0;
            for (unsigned n : counts) samples += n;
        }
        while (std::getline(man, line)) {
            std::istringstream ls(line);
            std::string name, type;
            int linear = 0;
            if (!(ls >> name >> type >> linear)) continue;
            Chan c{name,
                   type == "half" ? Imf::HALF
                   : type == "float" ? Imf::FLOAT : Imf::UINT,
                   linear != 0, {}};
            c.data.resize(type_size(c.type) * samples);
            data.read(c.data.data(), c.data.size());
            if (!data) throw std::runtime_error("short DATA file");
            chans.push_back(std::move(c));
        }
        Imf::Header hdr = header(chans, xmin, ymin, w, h, comp);
        if (comp_name.find(':') != std::string::npos)
            hdr.dwaCompressionLevel() =
                std::stof(comp_name.substr(comp_name.find(':') + 1));
        if (deep) {
            write_deep(out, layout, hdr, chans, counts, xmin, ymin, w, h);
            return 0;
        }
        if (layout == "yc") {
            write_yc(out, hdr, chans, xmin, ymin, w, h);
            return 0;
        }
        Imf::FrameBuffer fb = frame(chans, xmin, ymin, w);
        if (layout == "scanline") {
            Imf::OutputFile file(out.c_str(), hdr);
            file.setFrameBuffer(fb);
            file.writePixels(h);
        } else if (layout == "multipart") {
            Imf::Header h0 = hdr, h1 = hdr;
            h0.setName("first");
            h0.setType(Imf::SCANLINEIMAGE);
            h1.setName("second");
            h1.setType(Imf::TILEDIMAGE);
            h1.setTileDescription(Imf::TileDescription(16, 8, Imf::ONE_LEVEL));
            std::vector<Imf::Header> hs = {h0, h1};
            Imf::MultiPartOutputFile file(out.c_str(), hs.data(), 2);
            Imf::OutputPart p0(file, 0);
            p0.setFrameBuffer(fb);
            p0.writePixels(h);
            Imf::TiledOutputPart p1(file, 1);
            p1.setFrameBuffer(fb);
            p1.writeTiles(0, p1.numXTiles() - 1, 0, p1.numYTiles() - 1);
        } else {
            Imf::LevelMode mode = Imf::ONE_LEVEL;
            if (layout.rfind("mipmap", 0) == 0) mode = Imf::MIPMAP_LEVELS;
            if (layout.rfind("ripmap", 0) == 0) mode = Imf::RIPMAP_LEVELS;
            const Imf::LevelRoundingMode round =
                layout.size() > 3 && layout.substr(layout.size() - 3) == "_up"
                    ? Imf::ROUND_UP : Imf::ROUND_DOWN;
            hdr.setTileDescription(Imf::TileDescription(16, 8, mode, round));
            Imf::TiledOutputFile file(out.c_str(), hdr);
            file.setFrameBuffer(fb);
            write_levels(file, file.numXLevels(), file.numYLevels(),
                         mode == Imf::RIPMAP_LEVELS);
        }
        return 0;
    } catch (const std::exception& e) {
        std::cerr << "exr_writer: " << e.what() << "\n";
        return 1;
    }
}
