// Headless driver for the reference pipeline, used to measure the
// reference's CPU wall-clock per sequence so bench.py can gate the JAX
// build against a measured baseline instead of a self-relative one.
//
// The API shape follows the reference's own disabled headless path at
// /root/reference/src/main.cpp:43-66: construct pan::panorama from a file
// list, stitch_panorama(&conf), then get_preview() / get_panorama().
//
// Usage:
//   ref_headless IMG [IMG ...] [key=value ...] [--out=preview.jpg] [--full]
//
// key=value overrides pan::config fields (init_size, cut, proj, fast,
// blend, straighten, gain_compensation, blend_intensity, fix_center,
// RANSAC_iterations, max_keypoints, focal, threads, bands).
// Prints ONE JSON line: {"stitch_s":..,"preview_s":..,"full_s":..,
// "connected":..,"total":..,"n_images":..}.

#include "_panorama.h"
#include <chrono>
#include <iostream>
#include <string>
#include <vector>

static double now_s() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

int main(int argc, char **argv) {
    std::vector<std::string> files;
    pan::config conf;
    std::string out_path;
    bool full = false;

    for (int i = 1; i < argc; ++i) {
        std::string a = argv[i];
        if (a == "--full") {
            full = true;
            continue;
        }
        if (a.rfind("--out=", 0) == 0) {
            out_path = a.substr(6);
            continue;
        }
        auto eq = a.find('=');
        if (eq != std::string::npos && a.rfind("/", 0) != 0) {
            std::string k = a.substr(0, eq), v = a.substr(eq + 1);
            if (k == "init_size") conf.init_size = std::stoi(v);
            else if (k == "threads") conf.threads = std::stoi(v);
            else if (k == "cut") conf.cut = (v == "1" || v == "true");
            else if (k == "cut_seams") conf.cut_seams = (v == "1" || v == "true");
            else if (k == "fast") conf.fast = (v == "1" || v == "true");
            else if (k == "straighten") conf.straighten = (v == "1" || v == "true");
            else if (k == "gain_compensation") conf.gain_compensation = (v == "1" || v == "true");
            else if (k == "blend_intensity") conf.blend_intensity = (v == "1" || v == "true");
            else if (k == "fix_center") conf.fix_center = (v == "1" || v == "true");
            else if (k == "proj") conf.proj = (pan::Projection)pan::StringToProjection(v);
            else if (k == "blend") conf.blend = (pan::Blending)pan::StringToBlending(v);
            else if (k == "bands") conf.bands = std::stoi(v);
            else if (k == "RANSAC_iterations") conf.RANSAC_iterations = std::stoi(v);
            else if (k == "max_keypoints") conf.max_keypoints = std::stoi(v);
            else if (k == "focal") conf.focal = std::stof(v);
            else {
                std::cerr << "unknown key " << k << "\n";
                return 2;
            }
            continue;
        }
        files.push_back(a);
    }
    if (files.size() < 2) {
        std::cerr << "need >=2 images\n";
        return 2;
    }

    pan::panorama pano(files);

    double t0 = now_s();
    pano.stitch_panorama(&conf);
    double t_stitch = now_s() - t0;

    t0 = now_s();
    cv::Mat preview = pano.get_preview();
    double t_preview = now_s() - t0;

    double t_full = 0;
    if (full) {
        t0 = now_s();
        cv::Mat fullres = pano.get_panorama();
        t_full = now_s() - t0;
    }
    if (!out_path.empty()) cv::imwrite(out_path, preview);

    // stitch_panorama records "connected N of M" on its internal config
    // copy (conf_local.result, _panorama.cpp:497), not on the caller's.
    int connected = pano.conf_local.result.first;

    std::cout << "{\"stitch_s\": " << t_stitch
              << ", \"preview_s\": " << t_preview
              << ", \"full_s\": " << t_full
              << ", \"connected\": " << connected
              << ", \"n_images\": " << files.size()
              << ", \"total\": " << (t_stitch + t_preview + t_full) << "}"
              << std::endl;
    return 0;
}
