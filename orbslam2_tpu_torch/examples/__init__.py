"""The reference's example mains on the port: dataset drivers run as
``python -m orbslam2_tpu_torch.examples.<name>`` (rgbd_tum, mono_tum,
mono_kitti, mono_euroc, stereo_kitti, stereo_euroc). Each module's
``main(argv=None)`` parses its arguments and runs; importing one runs
nothing."""
