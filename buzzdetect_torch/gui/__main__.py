from buzzdetect_torch.gui import analyze_gui

if __name__ == '__main__':
    analyze_gui()
