"""Offline dataset preprocessing (raw downloads -> pc1.npy/pc2.npy dirs).

The port's copies of ``hplflownet_tpu/data/preprocess`` (numpy and
``multiprocessing`` only), writing the same files byte for byte:

* ``flyingthings3d``  FlyingThings3D subset: disparity, disparity change
  and optical flow -> point-cloud pairs;
* ``kitti``           KITTI Scene Flow 2015: disparity and flow PNGs plus
  the camera calibration -> point-cloud pairs.
"""
