// LBD oracle driver for golden-fixture reconciliation.
//
// Builds the reference's line_lbd library (read-only sources under
// /root/reference/line_lbd) and dumps stage-level golden data so the
// JAX LBD stack (cube_slam_wu_tpu/ops/lbd.py) can be pinned against
// the reference's ACTUAL computeLBD / binaryConversion / matcher output
// (line_lbd/libs/binary_descriptor.cpp:1150-1515, :405-416,
// binary_descriptor_matcher.cpp), not just re-derived band math.
//
// Modes (all outputs are plain text, packed into .npz by
// gen_lbd_fixtures.py; this tool is test infrastructure only — nothing from
// here ships in the framework package):
//   lbd_oracle gradients <image> <out_prefix>
//       GaussianBlur(5x5, sigma=1) as uint8 + Sobel 3x3 CV_16S dx/dy —
//       exactly BinaryDescriptor::computeSobel (binary_descriptor.cpp:
//       352-398) at octave 0.
//   lbd_oracle describe <image> <lines_txt> <out_prefix>
//       Build octave-0 KeyLines from txt rows "x1 y1 x2 y2", fill the
//       fields computeLBD reads (sPointInOctave*, angle=atan2, numOfPixels
//       via cv::LineIterator like fill_line_information,
//       line_lbd_allclass.cpp:42-66), then compute float (72) and binary
//       (32-byte) descriptors with useDetectionData=false.  Dumps
//       <out>_keylines.txt (x1 y1 x2 y2 angle numpix), <out>_desc72.txt,
//       <out>_desc256.txt.
//   lbd_oracle detect <image> <length_thres> <out_prefix>
//       Reference wrapper detect_filter_lines (EDLine, octave 0 filter,
//       line_lbd_allclass.cpp:211-235); dumps the detected keylines with
//       the same fields.
//   lbd_oracle match <desc256_a_txt> <desc256_b_txt> <out_file>
//       BinaryDescriptorMatcher::match (MIH); dumps rows
//       "queryIdx trainIdx distance" for ALL nearest-neighbour matches
//       (the dist<25 acceptance is the wrapper's filter,
//       line_lbd_allclass.cpp:352-369 — applied by the consumer).
#include <cmath>
#include <cstdio>
#include <fstream>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

#include <opencv2/opencv.hpp>

#include <line_lbd/line_descriptor.hpp>
#include "line_lbd/line_lbd_allclass.h"

using cv::line_descriptor::BinaryDescriptor;
using cv::line_descriptor::BinaryDescriptorMatcher;
using cv::line_descriptor::KeyLine;

static void dump_mat_int(const std::string& path, const cv::Mat& m) {
  std::ofstream f(path);
  for (int r = 0; r < m.rows; r++) {
    for (int c = 0; c < m.cols; c++) {
      long v = m.depth() == CV_8U    ? (long)m.at<unsigned char>(r, c)
               : m.depth() == CV_16S ? (long)m.at<short>(r, c)
                                     : (long)m.at<int>(r, c);
      f << v << (c + 1 < m.cols ? " " : "");
    }
    f << "\n";
  }
}

static void dump_mat_float(const std::string& path, const cv::Mat& m) {
  std::ofstream f(path);
  f.precision(9);
  for (int r = 0; r < m.rows; r++) {
    for (int c = 0; c < m.cols; c++) f << m.at<float>(r, c) << (c + 1 < m.cols ? " " : "");
    f << "\n";
  }
}

static void dump_keylines(const std::string& path, const std::vector<KeyLine>& kls) {
  std::ofstream f(path);
  f.precision(9);
  for (const KeyLine& kl : kls)
    f << kl.startPointX << " " << kl.startPointY << " " << kl.endPointX << " "
      << kl.endPointY << " " << kl.angle << " " << kl.numOfPixels << " "
      << kl.octave << " " << kl.response << " " << kl.lineLength << "\n";
}

static cv::Mat load_gray(const std::string& path) {
  cv::Mat img = cv::imread(path, cv::IMREAD_GRAYSCALE);
  if (img.empty()) {
    std::cerr << "image load failed: " << path << "\n";
    exit(1);
  }
  return img;
}

// KeyLine construction mirroring fill_line_information
// (line_lbd_allclass.cpp:42-66) for octave-0 segments.
static KeyLine make_keyline(float x1, float y1, float x2, float y2, int class_id,
                            const cv::Mat& img) {
  KeyLine kl;
  kl.sPointInOctaveX = x1;
  kl.sPointInOctaveY = y1;
  kl.ePointInOctaveX = x2;
  kl.ePointInOctaveY = y2;
  kl.startPointX = x1;
  kl.startPointY = y1;
  kl.endPointX = x2;
  kl.endPointY = y2;
  float dx = x2 - x1, dy = y2 - y1;
  kl.lineLength = std::sqrt(dx * dx + dy * dy);
  kl.angle = std::atan2(dy, dx);
  kl.pt = cv::Point2f((x1 + x2) / 2, (y1 + y2) / 2);
  kl.size = std::fabs(dx * dy);
  kl.response = kl.lineLength / (float)std::max(img.cols, img.rows);
  cv::LineIterator li(img, cv::Point2f(x1, y1), cv::Point2f(x2, y2));
  kl.numOfPixels = li.count;
  kl.octave = 0;
  kl.class_id = class_id;
  return kl;
}

static cv::Mat read_desc256(const std::string& path) {
  std::ifstream f(path);
  std::vector<std::vector<int>> rows;
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream ss(line);
    std::vector<int> row;
    int v;
    while (ss >> v) row.push_back(v);
    if (row.size() == 32) rows.push_back(row);
  }
  cv::Mat m((int)rows.size(), 32, CV_8UC1);
  for (int r = 0; r < (int)rows.size(); r++)
    for (int c = 0; c < 32; c++) m.at<unsigned char>(r, c) = (unsigned char)rows[r][c];
  return m;
}

int main(int argc, char** argv) {
  if (argc < 3) {
    std::cerr << "usage: lbd_oracle <mode> ...\n";
    return 1;
  }
  std::string mode = argv[1];

  if (mode == "gradients") {
    cv::Mat gray = load_gray(argv[2]);
    std::string out = argv[3];
    cv::Mat blurred;
    cv::GaussianBlur(gray, blurred, cv::Size(5, 5), 1);
    cv::Mat dx, dy;
    cv::Sobel(blurred, dx, CV_16SC1, 1, 0, 3);
    cv::Sobel(blurred, dy, CV_16SC1, 0, 1, 3);
    dump_mat_int(out + "_blur.txt", blurred);
    dump_mat_int(out + "_dx.txt", dx);
    dump_mat_int(out + "_dy.txt", dy);
    std::cerr << "gradients dumped: " << out << "\n";
    return 0;
  }

  if (mode == "describe") {
    cv::Mat gray = load_gray(argv[2]);
    std::string lines_txt = argv[3];
    std::string out = argv[4];

    std::vector<KeyLine> keylines;
    std::ifstream f(lines_txt);
    float x1, y1, x2, y2;
    int id = 0;
    while (f >> x1 >> y1 >> x2 >> y2)
      keylines.push_back(make_keyline(x1, y1, x2, y2, id++, gray));
    if (keylines.empty()) {
      std::cerr << "no lines read from " << lines_txt << "\n";
      return 1;
    }

    cv::Ptr<BinaryDescriptor> bd = BinaryDescriptor::createBinaryDescriptor();
    cv::Mat desc_f, desc_b;
    std::vector<KeyLine> kls_f = keylines, kls_b = keylines;
    bd->compute(gray, kls_f, desc_f, true);   // 72-float LBD
    bd->compute(gray, kls_b, desc_b, false);  // 32-byte binary
    dump_keylines(out + "_keylines.txt", keylines);
    dump_mat_float(out + "_desc72.txt", desc_f);
    dump_mat_int(out + "_desc256.txt", desc_b);
    std::cerr << "described " << keylines.size() << " lines: " << out << "\n";
    return 0;
  }

  if (mode == "detect") {
    cv::Mat gray = load_gray(argv[2]);
    float thres = std::atof(argv[3]);
    std::string out = argv[4];
    line_lbd_detect detector(1, std::sqrt(2.0));  // SLAM driver config
    detector.use_LSD = false;                     // main_obj.cpp:503
    detector.line_length_thres = thres;           // main_obj.cpp:504 (=15)
    cv::Mat rgb;
    cv::cvtColor(gray, rgb, cv::COLOR_GRAY2BGR);
    std::vector<KeyLine> keylines;
    detector.detect_filter_lines(rgb, keylines);
    dump_keylines(out + "_keylines.txt", keylines);
    std::cerr << "detected " << keylines.size() << " lines: " << out << "\n";
    return 0;
  }

  if (mode == "match") {
    cv::Mat da = read_desc256(argv[2]);
    cv::Mat db = read_desc256(argv[3]);
    std::string out = argv[4];
    cv::Ptr<BinaryDescriptorMatcher> bdm =
        BinaryDescriptorMatcher::createBinaryDescriptorMatcher();
    std::vector<cv::DMatch> matches;
    bdm->match(da, db, matches);
    std::ofstream f(out);
    for (const cv::DMatch& m : matches)
      f << m.queryIdx << " " << m.trainIdx << " " << m.distance << "\n";
    std::cerr << "matched " << matches.size() << " pairs: " << out << "\n";
    return 0;
  }

  std::cerr << "unknown mode " << mode << "\n";
  return 1;
}
