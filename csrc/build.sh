#!/bin/sh
# Build the native host-kernel library into the package directory.
set -e
cd "$(dirname "$0")"
g++ -O3 -march=native -shared -fPIC -std=c++17 hostkernels.cpp \
    -o ../cardiac_ablation_ecm2/_native.so
echo "built cardiac_ablation_ecm2/_native.so"
