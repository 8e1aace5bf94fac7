"""KITTI evaluation of the port: the eigen protocol and GT export."""
