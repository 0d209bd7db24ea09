"""View-rig plan datatypes, presets and the addcam/delcam/setcam grammar."""
