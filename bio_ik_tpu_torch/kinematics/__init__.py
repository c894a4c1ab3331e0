from .fk import LinkFrames, joint_frame, make_fk, make_link_frames_fn  # noqa: F401
